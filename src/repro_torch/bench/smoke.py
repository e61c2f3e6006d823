"""The port's smoke path: ``python -m repro_torch.bench.smoke [--path P]``.

The counterpart of the reference's ``python -m benchmarks.run --smoke``
(`benchmarks/run.py::smoke`), on the port's lockstep lanes. It runs on the
card (`smoke(device="cpu")` asks for the CPU) over the reference smoke's own
cells: fig5's YCSB deployment (4 data sources at 0/27/73/251 ms, 1M records
per node, zipf 0.9, 20% distributed, 5 ops) at T = 32, horizon 2.5 s,
warmup 0.5 s, each seed with its own bank. Five legs, every one on the vmap
lanes:

1. ``grid``: ssp / ssp-local / scalardb / geotp x seeds 0-3 (16 lanes),
   the windowed drain (the default);
2. ``single``: the same grid with ``drain=False``, in place of the
   reference's sequential ``map`` leg (`strategy="map"` runs in the port,
   but it is the slow path on the card; see ROADMAP);
3. ``faults``: ssp / geotp under SMOKE_FAULTS (two crash / recovery cycles);
4. ``partitions``: ssp / geotp under SMOKE_PARTITIONS (a middleware cut and
   a degraded link), replicas SMOKE_REPLICAS;
5. ``protocols``: ssp / geotp / fastc / tiga / opta x seeds 0-1, warmup 0.

Each leg is recorded under ``sweeps.smoke_<leg>`` in the port's bench file.
The guards are the reference's semantic ones; a failure prints the
reference's message, records the entry and returns 1:

* partitions: 0 < availability < 1, failovers > 0, stale reads > 0, and
  commits on every cell;
* faults: 0 < availability < 1, and commits on every cell;
* protocols: FASTC's WAN rounds a finished transaction strictly below SSP's
  on each seed;
* the drained grid's drain hit rate > 0;

and one the port adds, which the reference's ``map`` leg implies: legs 1
and 2 give equal events, commits and aborts in every cell.

Left out, and why (printed by every run):

* the reference's stored-baseline ratchets (events/s at 70% of a stored
  baseline, mean window length, scheduled-stop share) compare speed and
  windows with a file written on the same host; the port has no stored
  baseline, so it records these numbers and does not gate on them;
* the seed comparator (`engine.simulate`, the sequential single-world
  entry: the slow path on the card), so the entry has no
  ``events_per_sec_seed`` or ``speedup_vs_seed``.

The entry (``smoke`` in the bench file, `record_smoke`) has the reference's
keys less those two, plus `runtime_env`'s and ``map_leg``. Its ``*_map``
keys hold leg 2, the single-event stand-in for the map leg, and ``map_leg``
says so in the entry itself: ``vmap_vs_map`` is drained against
single-event, not vmap against map. The drain telemetry
(``drain_hit_rate``, ``mean_window_len``, ``window_stops``, ``chained``,
``scheduled_stop_share``) and the ``*_batched`` keys hold leg 1, the
default path, whose cells equal the reference's drained map leg's.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch.bench import common
from repro_torch.core.engine import BENCH_FILE, record_smoke
from repro_torch.core.engine.metrics import drain_stats
from repro_torch.device import resolve_device

SMOKE_PRESETS = ("ssp", "ssp-local", "scalardb", "geotp")
SMOKE_SEEDS = (0, 1, 2, 3)
SMOKE_T = 32
SMOKE_HORIZON_S = 2.5
SMOKE_WARMUP_S = 0.5
# crash-heavy fault schedule: two full crash / recovery cycles inside the
# horizon ((t_crash_us, ds, t_recover_us) rows, the paper's 4-DS layout)
SMOKE_FAULTS = ((500_000, 0, 1_000_000), (1_200_000, 2, 1_900_000))
# partition-heavy typed rows: a long asymmetric middleware cut (admissions
# during the cut fail over to the replica) plus a degraded link
SMOKE_PARTITIONS = (
    (600_000, 1, -1, 1, 2_300_000, 0),  # KIND_PARTITION, MW<->ds1
    (800_000, 2, -1, 2, 2_000_000, 4_000),  # KIND_DEGRADE, MW<->ds2, 4x
)
SMOKE_REPLICAS = dict(replica_tau=(30_000,) * 4, repl_lag_us=500_000)
# the commit-path presets measured by the receive-side wan_rounds counter
SMOKE_PROTOCOLS = ("ssp", "geotp", "fastc", "tiga", "opta")
LEGS = ("grid", "single", "faults", "partitions", "protocols")
# the reference entry's keys the port does not write (the seed comparator)
LEFT_OUT = ("events_per_sec_seed", "speedup_vs_seed")
# the key the port adds: what its *_map keys measure
MAP_LEG = ("single-event vmap lanes (drain=False), in place of the sequential map strategy "
           "(the slow path on the card)")
LEFT_OUT_NOTE = (
    "[smoke] left out: the stored-baseline ratchets (events/s at 70% of a stored baseline, "
    "mean window, scheduled-stop share; recorded, not gated: the port has no stored "
    "baseline) and the seed comparator (engine.simulate is the sequential slow path on "
    "the card: no events_per_sec_seed / speedup_vs_seed)"
)


@dataclasses.dataclass
class SmokeRun:
    """What `smoke` ran: its return code, the recorded entry, and each leg's
    RunResult and wall seconds (the bench file's write included)."""

    rc: int
    entry: dict
    results: dict
    walls: dict


def leg_cells() -> dict:
    """Each leg's cells (the reference smoke's), warmup and step (drained
    or not)."""
    grid = [dict(preset=p, seed=sd) for sd in SMOKE_SEEDS for p in SMOKE_PRESETS]
    return {
        "grid": (grid, SMOKE_WARMUP_S, True),
        "single": (grid, SMOKE_WARMUP_S, False),
        "faults": ([dict(preset=p, seed=0, faults=SMOKE_FAULTS) for p in ("ssp", "geotp")],
                   SMOKE_WARMUP_S, True),
        "partitions": ([dict(preset=p, seed=0, faults=SMOKE_PARTITIONS, **SMOKE_REPLICAS)
                        for p in ("ssp", "geotp")], SMOKE_WARMUP_S, True),
        "protocols": ([dict(preset=p, seed=sd) for sd in SMOKE_SEEDS[:2]
                       for p in SMOKE_PROTOCOLS],
                      0.0, True),
    }


# ---------------------------------------------------------------------------
# guards: None when the leg holds, else the reference's message
# ---------------------------------------------------------------------------


def protocol_guard(wan_per_txn: dict, seeds) -> str | None:
    """FASTC's WAN rounds per finished txn strictly below SSP's on every
    seed (`wan_per_txn` keyed by (preset, seed))."""
    if all(wan_per_txn[("fastc", sd)] < wan_per_txn[("ssp", sd)] for sd in seeds):
        return None
    return (
        "[smoke] PROTOCOL REGRESSION: FASTC wan/txn not strictly below SSP on every cell: "
        + ", ".join(f"seed {sd}: fastc={wan_per_txn[('fastc', sd)]:.2f} vs "
                    f"ssp={wan_per_txn[('ssp', sd)]:.2f}" for sd in seeds)
    )


def partition_guard(d_part: dict, metrics: list) -> str | None:
    if (0.0 < d_part["availability"] < 1.0 and d_part["failovers"] > 0
            and d_part["stale_reads"] > 0 and all(m["commits"] > 0 for m in metrics)):
        return None
    return (
        f"[smoke] PARTITION REGRESSION: typed schedule reported "
        f"availability={d_part['availability']}, failovers={d_part['failovers']}, "
        f"stale_reads={d_part['stale_reads']}, commits={[m['commits'] for m in metrics]} — "
        f"the cut was not injected or the failover path went dead"
    )


def fault_guard(d_fault: dict, metrics: list) -> str | None:
    if 0.0 < d_fault["availability"] < 1.0 and all(m["commits"] > 0 for m in metrics):
        return None
    return (
        f"[smoke] FAULT REGRESSION: crash-heavy schedule reported "
        f"availability={d_fault['availability']} and commits="
        f"{[m['commits'] for m in metrics]} — outages not injected or recovery failed to "
        f"re-admit"
    )


def drain_guard(d_grid: dict) -> str | None:
    if d_grid["drain_hit_rate"] > 0.0:
        return None
    return (
        "[smoke] LOCKSTEP DRAIN REGRESSION: vmap drain hit rate is 0 — lockstep lanes are "
        "running with draining disabled again (the silent simulate_batch downgrade this "
        "guard exists to catch)"
    )


def legs_equal_guard(cells: list, m_grid: list, m_single: list) -> str | None:
    """The drained and single-event legs process the same events: equal
    events, commits and aborts in every cell."""
    keys = ("events", "commits", "aborts")
    bad = [(i, c["preset"], c.get("seed"), {k: (a[k], b[k]) for k in keys if a[k] != b[k]})
           for i, (c, a, b) in enumerate(zip(cells, m_grid, m_single))
           if any(a[k] != b[k] for k in keys)]
    if not bad:
        return None
    return (f"[smoke] DRAIN PARITY REGRESSION: the drained and single-event legs differ "
            f"(cell, preset, seed, {{key: (drained, single-event)}}): {bad}")


# ---------------------------------------------------------------------------
# the smoke
# ---------------------------------------------------------------------------


def _leg_line(name: str, res, wall: float) -> str:
    d = res.drain
    return (f"[smoke] {name}: {len(res)} worlds, {res.events} events, {res.steps} steps, "
            f"{wall:.3f} s (capture included) -> {res.events / max(wall, 1e-9):.1f} events/sec, "
            f"{res.steps / max(res.wall_s, 1e-9):.1f} steps/s (drain hit "
            f"{d['drain_hit_rate']:.4f}, mean window {d['mean_window_len']}, "
            f"{d['loop_iters']} loop iters)")


def smoke(path=None, *, device=None) -> SmokeRun:
    """Run the five legs, check the guards and record the entry. Returns a
    `SmokeRun` whose `rc` is 0 when every guard held, else 1."""
    dev = resolve_device(device)
    t_all = time.time()
    banks = {sd: common.ycsb_bank(SMOKE_T, theta=0.9, dist_ratio=0.2, seed=sd)
             for sd in SMOKE_SEEDS}
    plan = leg_cells()
    results, walls = {}, {}
    for name, (cells, warmup_s, drain) in plan.items():
        t0 = time.time()
        results[name] = common.run_sweep(
            f"smoke_{name}", cells, None, SMOKE_T, banks=[banks[c["seed"]] for c in cells],
            horizon_s=SMOKE_HORIZON_S, warmup_s=warmup_s, path=path, drain=drain, device=dev,
        )
        walls[name] = time.time() - t0
        print(_leg_line(name, results[name], walls[name]), flush=True)
    res_g, res_s = results["grid"], results["single"]
    d_grid, d_single = res_g.drain, res_s.drain
    eps_g = res_g.events / max(walls["grid"], 1e-9)
    eps_s = res_s.events / max(walls["single"], 1e-9)
    stops = d_grid["window_stops"]
    n_stops = max(sum(stops.values()), 1)
    sched_share = round(stops.get("scheduled", 0) / n_stops, 4)
    print("[smoke] window stops (drained): "
          + ", ".join(f"{k}={c}" for k, c in sorted(stops.items(), key=lambda kv: -kv[1]))
          + f"; chained {d_grid['chained']}, scheduled share {sched_share:.1%}; plan fused: "
          f"{d_grid['plan_fused']}; drained / single-event events/sec "
          f"{eps_g / max(eps_s, 1e-9):.4f}")

    res_f, res_p, res_z = results["faults"], results["partitions"], results["protocols"]
    d_fault, d_part = res_f.drain, res_p.drain
    print(f"[smoke] faults: availability {d_fault['availability']:.4f}, crash aborts "
          f"{d_fault['abort_causes']['crash']}, commits during fault "
          f"{d_fault['commits_during_fault']}")
    print(f"[smoke] partitions: availability {d_part['availability']:.4f}, failovers "
          f"{d_part['failovers']}, stale reads {d_part['stale_reads']} (max staleness "
          f"{d_part['max_staleness_us']}us)")
    proto_cells = plan["protocols"][0]
    wall_cell = walls["protocols"] / max(len(proto_cells), 1)
    wan_per_txn, proto_rec = {}, {}
    for i, (c, m) in enumerate(zip(proto_cells, res_z.metrics)):
        d = drain_stats(res_z.world(i), horizon_us=res_z.cfg.horizon_us)
        wan_per_txn[(c["preset"], c["seed"])] = d["wan_rounds"] / max(
            m["commits"] + m["aborts"], 1)
        rec = proto_rec.setdefault(
            c["preset"], {"events": 0, "wan_rounds": 0.0, "fast_commits": 0, "cells": 0})
        rec["events"] += m["events"]
        rec["wan_rounds"] += d["wan_rounds"]
        rec["fast_commits"] += d["fast_commits"]
        rec["cells"] += 1
    for p, rec in proto_rec.items():
        rec["events_per_sec"] = round(rec["events"] / max(rec["cells"] * wall_cell, 1e-9), 1)
        rec["wan_per_txn"] = round(
            sum(v for (pp, _), v in wan_per_txn.items() if pp == p) / rec.pop("cells"), 3)
    print("[smoke] protocols wan/txn: "
          + ", ".join(f"{p}={proto_rec[p]['wan_per_txn']:.2f}" for p in SMOKE_PROTOCOLS)
          + f"; fastc fast commits {proto_rec['fastc']['fast_commits']}, tiga fast commits "
          f"{proto_rec['tiga']['fast_commits']}")
    print(LEFT_OUT_NOTE)

    entry = {
        "worlds": len(plan["grid"][0]),
        "terminals": SMOKE_T,
        "horizon_s": SMOKE_HORIZON_S,
        "events_batched": res_g.events,
        "wall_batched_s": round(walls["grid"], 2),
        "events_per_sec_batched": round(eps_g, 1),
        "events_per_sec_map": round(eps_s, 1),
        "events_per_sec_vmap": round(eps_g, 1),
        "vmap_vs_map": round(eps_g / max(eps_s, 1e-9), 3),
        "drain_hit_rate": d_grid["drain_hit_rate"],
        "drain_hit_rate_vmap": d_grid["drain_hit_rate"],
        "mean_window_len": d_grid["mean_window_len"],
        "window_stops": stops,
        "chained": d_grid["chained"],
        "scheduled_stop_share": sched_share,
        "plan_fused_vmap": d_grid["plan_fused"],
        "loop_iters_map": d_single["loop_iters"],
        "loop_iters_vmap": d_grid["loop_iters"],
        "map_leg": MAP_LEG,
        "availability_fault": d_fault["availability"],
        "abort_causes_fault": d_fault["abort_causes"],
        "commits_during_fault": d_fault["commits_during_fault"],
        "wall_fault_s": round(walls["faults"], 2),
        "availability_partition": d_part["availability"],
        "failovers_partition": d_part["failovers"],
        "stale_reads_partition": d_part["stale_reads"],
        "max_staleness_us_partition": d_part["max_staleness_us"],
        "wall_partition_s": round(walls["partitions"], 2),
        "protocols": proto_rec,
        "wall_protocols_s": round(walls["protocols"], 2),
        "total_wall_s": round(time.time() - t_all, 2),
    }
    failures = (
        protocol_guard(wan_per_txn, SMOKE_SEEDS[:2]),
        partition_guard(d_part, res_p.metrics),
        fault_guard(d_fault, res_f.metrics),
        drain_guard(d_grid),
        legs_equal_guard(plan["grid"][0], res_g.metrics, res_s.metrics),
    )
    msg = next((f for f in failures if f is not None), None)
    entry = record_smoke(entry, path, device=dev)
    if msg is not None:
        print(msg)
        return SmokeRun(1, entry, results, walls)
    print(f"[smoke] OK: recorded in {path if path is not None else BENCH_FILE}")
    return SmokeRun(0, entry, results, walls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default=None,
                    help="the bench file to record into (default: results/bench_torch/"
                         "BENCH_engine.json)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the default is the card")
    args = ap.parse_args(argv)
    return smoke(args.path, device=args.device).rc


if __name__ == "__main__":
    sys.exit(main())
