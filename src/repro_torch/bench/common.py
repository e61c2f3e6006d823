"""Shared benchmark harness, the port's counterpart of the reference's
`benchmarks/common.py`: a thin client of `repro_torch.core.engine`.

`run_sweep` turns a grid of cells into a `Grid` and runs it through a
`Simulator` as [B] lockstep lanes on one device (or as sequential lanes
with ``strategy="map"``), returning the `RunResult`; with `record` it saves
the run under ``sweeps.<tag>`` in the port's bench file
(`engine.api.BENCH_FILE`, or `path`). `run_point` runs one cell through the
same facade. `save` writes a figure's payload as
``results/bench_torch/<name>.json``, never under the reference's
``results/bench/``.
"""

from __future__ import annotations

import json
import pathlib

from repro_torch.core import workloads
from repro_torch.core.engine import (
    BENCH_DIR,
    BENCH_FILE,
    Grid,
    RunResult,
    Simulator,
    load_bench,
    make_world,
    record_bench,
    record_smoke,
)
from repro_torch.core.netmodel import PAPER_RTT_MS, make_net_params

RESULTS = BENCH_DIR
DEFAULT_RTT = PAPER_RTT_MS

__all__ = [
    "BENCH_FILE", "DEFAULT_RTT", "RESULTS", "load_bench", "record_bench", "record_smoke",
    "run_point", "run_sweep", "save", "summary_line", "ycsb_bank",
]


def save(name: str, payload, results_dir=None) -> pathlib.Path:
    """Write a figure's payload as ``<results_dir>/<name>.json`` (the port's
    `RESULTS` directory unless given), as the reference writes it."""
    d = pathlib.Path(results_dir) if results_dir is not None else RESULTS
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{name}.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def run_point(
    preset: str,
    bank,
    terminals: int,
    rtt_ms=DEFAULT_RTT,
    jitter_milli: int = 30,
    horizon_s: float = 10.0,
    warmup_s: float = 2.0,
    exec_scale_milli=None,
    proto_override=None,
    tau_true_us=None,
    *,
    device=None,
):
    """Run one cell through the Simulator facade; returns (RunResult, metrics)."""
    proto = proto_override or preset
    net = make_net_params(rtt_ms)
    sim = Simulator(
        terminals=terminals,
        max_ops=bank.key.shape[-1],
        num_ds=len(rtt_ms),
        bank_txns=bank.key.shape[1],
        proto=proto,
        horizon_s=horizon_s,
        warmup_s=warmup_s,
        device=device,
    )
    world = make_world(
        proto,
        tau_true_us=tau_true_us if tau_true_us is not None else net.tau_dm,
        tau_ds_us=net.tau_ds,
        jitter_milli=jitter_milli,
        exec_scale_milli=exec_scale_milli,
    )
    res = sim.run(world, bank, labels=dict(preset=preset))
    m = res.metrics[0]
    m["wall_s"] = round(res.wall_s, 1)
    m["preset"] = preset
    return res, m


def run_sweep(
    tag: str,
    cells: list,
    bank,
    terminals: int,
    *,
    banks: list | None = None,
    horizon_s: float = 10.0,
    warmup_s: float = 2.0,
    strategy: str = "auto",
    mesh_devices: int | None = None,
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
    strategy: ``auto`` (`placement.resolve_strategy`), ``vmap`` (lockstep
           lanes), ``map`` (sequential lanes) or ``mesh`` (the grid split
           over `mesh_devices` devices, default every one the census
           counts).
    drain: the windowed drain (the default) or the single-event step.
    """
    grid = Grid(cells, banks=banks)
    b0 = banks[0] if banks is not None else bank
    sim = Simulator.from_bank(b0, terminals=terminals, horizon_s=horizon_s, warmup_s=warmup_s,
                              drain=drain, device=device)
    res = sim.run_grid(grid, bank, strategy=strategy, mesh_devices=mesh_devices)
    for c, m in zip(cells, res.metrics):
        m["preset"] = c["preset"]
        # per-cell cost is amortized over the lanes; the grid's wall goes in
        # sweep_wall_s
        m["wall_s"] = round(res.wall_s / len(cells), 2)
        m["sweep_wall_s"] = round(res.wall_s, 1)
    if record:
        res.save(tag, path)
    return res


def ycsb_bank(
    terminals: int,
    theta: float = 0.9,
    dist_ratio: float = 0.2,
    ops: int = 5,
    rounds: int = 1,
    records: int = 1_000_000,
    num_ds: int = 4,
    seed: int = 0,
    quro: bool = False,
):
    """The figures' YCSB bank (the reference's defaults: 4 data sources, 1M
    records a node, 5 ops a transaction, one round), 256 transactions a
    terminal; `quro` reorders each transaction's ops as QURO does."""
    cfg = workloads.YCSBConfig(
        num_ds=num_ds,
        records_per_node=records,
        ops_per_txn=ops,
        dist_ratio=dist_ratio,
        theta=theta,
        rounds=rounds,
        seed=seed,
    )
    bank = workloads.make_ycsb_bank(cfg, terminals, txns_per_terminal=256)
    if quro:
        bank = workloads.quro_reorder(bank)
    return bank


def summary_line(tag: str, m: dict) -> str:
    return (
        f"{tag:44s} tps={m['throughput_tps']:8.1f} avg={m['avg_latency_ms']:8.1f}ms "
        f"p99={m['p99_ms']:8.1f}ms abort={m['abort_rate']:.3f} lcs={m['avg_lcs_ms']:7.1f}ms"
    )
