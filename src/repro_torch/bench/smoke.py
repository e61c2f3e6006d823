"""The port's smoke path: ``python -m repro_torch.bench.smoke [--path P]``.

The counterpart of the reference's ``python -m benchmarks.run --smoke``
(`benchmarks/run.py::smoke`) over the reference smoke's own cells: fig5's
YCSB deployment (4 data sources at 0/27/73/251 ms, 1M records per node,
zipf 0.9, 20% distributed, 5 ops) at T = 32, horizon 2.5 s, warmup 0.5 s,
each seed with its own bank. It runs on the card (`smoke(device="cpu")`
asks for the CPU), every leg drained, in three parts:

* the card legs (`card_legs`), on the lockstep lanes (``strategy="vmap"``,
  named, so that on the CPU too, where ``auto`` picks the map lanes, they
  run the lockstep lanes):

  1. ``grid``: ssp / ssp-local / scalardb / geotp x seeds 0-3 (16 lanes);
  3. ``faults``: ssp / geotp under SMOKE_FAULTS (two crash / recovery
     cycles);
  4. ``partitions``: ssp / geotp under SMOKE_PARTITIONS (a middleware cut
     and a degraded link), replicas SMOKE_REPLICAS;
  5. ``protocols``: ssp / geotp / fastc / tiga / opta x seeds 0-1, warmup 0;

* the CPU legs (`cpu_legs`), always on the CPU (``device="cpu"``, said in
  the leg's line and in the entry's ``map_device``):

  2. ``map``: the reference's sequential leg, leg 1's grid through
     ``strategy="map"``. The reference's own ``auto`` table puts the map
     lanes on the CPU, and there they cost ~1 host ms an event against
     10-18 on the card, so the smoke asks for the CPU for this one leg;
  * the seed comparator: `engine.simulate` on the first seed's ssp cell,
    single-event, one world, beside the map leg on the same device, so that
    ``speedup_vs_seed`` divides two rates of one device;

* `finish`: the guards and the entry.

`smoke` runs the three in turn; `chip_smoke.py` runs the CPU legs in a
process of its own beside the card's phases and hands their result to
`finish`. Each leg is recorded under ``sweeps.smoke_<leg>`` in the port's
bench file.

``smoke_mesh`` (``python -m repro_torch.bench.run --smoke --strategy
mesh``) is the counterpart of the reference's ``smoke_mesh``: leg 1's grid
under the mesh placement, split over every device the census counts.
The guards are the reference's semantic ones; a failure prints the
reference's message, records the entry and returns 1:

* partitions: 0 < availability < 1, failovers > 0, stale reads > 0, and
  commits on every cell;
* faults: 0 < availability < 1, and commits on every cell;
* protocols: FASTC's WAN rounds a finished transaction strictly below SSP's
  on each seed;
* the vmap leg's drain hit rate > 0;

and one the port adds, which the reference's two grid legs imply: legs 1
and 2 (vmap on the card, map on the CPU) give equal events, commits and
aborts in every cell.

Left out, and why (printed by every run): the reference's stored-baseline
ratchets (events/s at 70% of a stored baseline, mean window length,
scheduled-stop share) compare speed and windows with a file written on the
same host; the port has no stored baseline yet, so it records these numbers
and does not gate on them.

The entry (``smoke`` in the bench file, `record_smoke`) has the reference's
keys, as the reference fills them (the ``*_map`` keys, the drain telemetry
and the ``*_batched`` keys from the map leg, the ``*_vmap`` keys from leg
1), plus `runtime_env`'s and ``map_device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch.bench import common
from repro_torch.core.engine import (
    BENCH_FILE,
    RunResult,
    SimConfig,
    load_bench,
    mesh_device_count,
    record_smoke,
    simulate,
)
from repro_torch.core.engine.metrics import drain_stats
from repro_torch.core.netmodel import make_net_params
from repro_torch.core.protocol import PRESETS
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
LEGS = ("grid", "map", "faults", "partitions", "protocols")
CARD_LEGS = ("grid", "faults", "partitions", "protocols")
# the map leg and the seed comparator run here, whatever the smoke's device
CPU_DEVICE = "cpu"
LEFT_OUT_NOTE = (
    "[smoke] left out: the stored-baseline ratchets (events/s at 70% of a stored baseline, "
    "mean window, scheduled-stop share; recorded, not gated: the port has no stored "
    "baseline)"
)


@dataclasses.dataclass
class SmokeRun:
    """What `smoke` ran: its return code, the recorded entry, and each leg's
    RunResult and wall seconds (the bench file's write included)."""

    rc: int
    entry: dict
    results: dict
    walls: dict


@dataclasses.dataclass
class CpuLegs:
    """The CPU legs' results: the map leg's RunResult and wall seconds, and
    the seed comparator's events and wall seconds."""

    map: RunResult
    map_wall: float
    seed_events: int
    seed_wall: float


def leg_cells() -> dict:
    """Each leg's cells (the reference smoke's), warmup and strategy; every
    leg runs the windowed drain."""
    grid = [dict(preset=p, seed=sd) for sd in SMOKE_SEEDS for p in SMOKE_PRESETS]
    return {
        "grid": (grid, SMOKE_WARMUP_S, "vmap"),
        "map": (grid, SMOKE_WARMUP_S, "map"),
        "faults": ([dict(preset=p, seed=0, faults=SMOKE_FAULTS) for p in ("ssp", "geotp")],
                   SMOKE_WARMUP_S, "vmap"),
        "partitions": ([dict(preset=p, seed=0, faults=SMOKE_PARTITIONS, **SMOKE_REPLICAS)
                        for p in ("ssp", "geotp")], SMOKE_WARMUP_S, "vmap"),
        "protocols": ([dict(preset=p, seed=sd) for sd in SMOKE_SEEDS[:2]
                       for p in SMOKE_PROTOCOLS],
                      0.0, "vmap"),
    }


def smoke_banks() -> dict:
    """{seed: its YCSB bank} (built on the host)."""
    return {sd: common.ycsb_bank(SMOKE_T, theta=0.9, dist_ratio=0.2, seed=sd)
            for sd in SMOKE_SEEDS}


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


def legs_equal_guard(cells: list, m_vmap: list, m_map: list) -> str | None:
    """The vmap leg (the card's lockstep lanes) and the map leg (the CPU's
    sequential lanes) process the same events: equal events, commits and
    aborts in every cell."""
    keys = ("events", "commits", "aborts")
    bad = [(i, c["preset"], c.get("seed"), {k: (a[k], b[k]) for k in keys if a[k] != b[k]})
           for i, (c, a, b) in enumerate(zip(cells, m_vmap, m_map))
           if any(a[k] != b[k] for k in keys)]
    if not bad and len(m_vmap) == len(m_map) == len(cells):
        return None
    return (f"[smoke] STRATEGY PARITY REGRESSION: the vmap and map legs differ (cell, preset, "
            f"seed, {{key: (vmap, map)}}): {bad}, {len(m_vmap)} vs {len(m_map)} cells")


# ---------------------------------------------------------------------------
# the legs
# ---------------------------------------------------------------------------


def _leg_line(name: str, res, wall: float) -> str:
    d = res.drain
    return (f"[smoke] {name} ({res.strategy_resolved} lanes on the "
            f"{res.states.now.device.type}): {len(res)} worlds, {res.events} events, "
            f"{res.steps} steps, {wall:.3f} s (capture included) -> "
            f"{res.events / max(wall, 1e-9):.1f} events/sec, "
            f"{res.steps / max(res.wall_s, 1e-9):.1f} steps/s (drain hit "
            f"{d['drain_hit_rate']:.4f}, mean window {d['mean_window_len']}, "
            f"{d['loop_iters']} loop iters)")


def run_leg(name: str, banks: dict, path=None, *, device=None, record: bool = True):
    """One leg through `common.run_sweep` (recorded under ``smoke_<name>``
    unless not `record`): (its RunResult, its wall seconds)."""
    cells, warmup_s, strategy = leg_cells()[name]
    t0 = time.time()
    res = common.run_sweep(
        f"smoke_{name}", cells, None, SMOKE_T, banks=[banks[c["seed"]] for c in cells],
        horizon_s=SMOKE_HORIZON_S, warmup_s=warmup_s, strategy=strategy, record=record,
        path=path, device=device,
    )
    wall = time.time() - t0
    print(_leg_line(name, res, wall), flush=True)
    return res, wall


def card_legs(path=None, *, device=None, banks=None) -> tuple[dict, dict]:
    """Legs 1, 3, 4 and 5 on `device` (None: the card): ({leg: RunResult},
    {leg: wall seconds})."""
    dev = resolve_device(device)
    banks = banks or smoke_banks()
    results, walls = {}, {}
    for name in CARD_LEGS:
        results[name], walls[name] = run_leg(name, banks, path, device=dev)
    return results, walls


def seed_leg(bank) -> tuple[int, float]:
    """The seed comparator (the reference's): `engine.simulate` on one
    world, the single-event step, ssp at the paper's RTTs, jitter 30, on
    the CPU: (events, wall seconds)."""
    net = make_net_params()
    cfg = SimConfig(terminals=SMOKE_T, max_ops=5, num_ds=4, bank_txns=256,
                    proto=PRESETS["ssp"], warmup_us=int(SMOKE_WARMUP_S * 1e6),
                    horizon_us=int(SMOKE_HORIZON_S * 1e6), drain=False)
    t0 = time.time()
    _, m = simulate(cfg, bank, net.tau_dm, net.tau_ds, jitter_milli=30, device=CPU_DEVICE)
    wall = time.time() - t0
    print(f"[smoke] seed engine cell (engine.simulate on the {CPU_DEVICE}): {m['events']} "
          f"events, {wall:.3f} s -> {m['events'] / max(wall, 1e-9):.1f} events/sec", flush=True)
    return m["events"], wall


def cpu_legs(banks=None) -> CpuLegs:
    """Leg 2 (the map leg) and the seed comparator, on the CPU. The map
    leg's sweep is recorded by `finish`, with the others."""
    banks = banks or smoke_banks()
    res, wall = run_leg("map", banks, device=CPU_DEVICE, record=False)
    events, wall_seed = seed_leg(banks[SMOKE_SEEDS[0]])
    return CpuLegs(res, wall, events, wall_seed)


# ---------------------------------------------------------------------------
# the guards and the entry
# ---------------------------------------------------------------------------


def finish(results: dict, walls: dict, cpu: CpuLegs, path=None, *, device=None,
           t_all: float) -> SmokeRun:
    """Check the guards over the card legs (`card_legs`) and the CPU legs
    (`cpu_legs`), record the map leg's sweep and the entry. `t_all`: when
    the smoke began (for ``total_wall_s``). Returns a `SmokeRun` whose `rc`
    is 0 when every guard held, else 1."""
    dev = resolve_device(device)
    results = {**results, "map": cpu.map}
    walls = {**walls, "map": cpu.map_wall}
    res_v, res_m = results["grid"], cpu.map
    d_vmap, d_map = res_v.drain, res_m.drain
    eps_v = res_v.events / max(walls["grid"], 1e-9)
    eps_m = res_m.events / max(cpu.map_wall, 1e-9)
    eps_seed = cpu.seed_events / max(cpu.seed_wall, 1e-9)
    speedup = eps_m / max(eps_seed, 1e-9)
    stops = d_map["window_stops"]
    n_stops = max(sum(stops.values()), 1)
    sched_share = round(stops.get("scheduled", 0) / n_stops, 4)
    print(f"[smoke] vmap ({dev.type}) / map ({CPU_DEVICE}) events/sec ratio: "
          f"{eps_v / max(eps_m, 1e-9):.4f} (drain hit rate map: {d_map['drain_hit_rate']:.4f}, "
          f"vmap: {d_vmap['drain_hit_rate']:.4f})")
    print("[smoke] window stops (map): "
          + ", ".join(f"{k}={c}" for k, c in sorted(stops.items(), key=lambda kv: -kv[1]))
          + f"; chained {d_map['chained']}, scheduled share {sched_share:.1%}; vmap plan fused: "
          f"{d_vmap['plan_fused']}")
    print(f"[smoke] seed engine cell on the {CPU_DEVICE}: {eps_seed:.1f} events/sec; the map "
          f"leg's speedup over it {speedup:.4f}x")

    res_f, res_p, res_z = results["faults"], results["partitions"], results["protocols"]
    d_fault, d_part = res_f.drain, res_p.drain
    print(f"[smoke] faults: availability {d_fault['availability']:.4f}, crash aborts "
          f"{d_fault['abort_causes']['crash']}, commits during fault "
          f"{d_fault['commits_during_fault']}")
    print(f"[smoke] partitions: availability {d_part['availability']:.4f}, failovers "
          f"{d_part['failovers']}, stale reads {d_part['stale_reads']} (max staleness "
          f"{d_part['max_staleness_us']}us)")
    plan = leg_cells()
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

    res_m.save("smoke_map", path)
    entry = {
        "worlds": len(plan["grid"][0]),
        "terminals": SMOKE_T,
        "horizon_s": SMOKE_HORIZON_S,
        "events_batched": res_m.events,
        "wall_batched_s": round(cpu.map_wall, 2),
        "events_per_sec_batched": round(eps_m, 1),
        "events_per_sec_map": round(eps_m, 1),
        "events_per_sec_vmap": round(eps_v, 1),
        "vmap_vs_map": round(eps_v / max(eps_m, 1e-9), 3),
        "drain_hit_rate": d_map["drain_hit_rate"],
        "drain_hit_rate_vmap": d_vmap["drain_hit_rate"],
        "mean_window_len": d_map["mean_window_len"],
        "window_stops": stops,
        "chained": d_map["chained"],
        "scheduled_stop_share": sched_share,
        "plan_fused_vmap": d_vmap["plan_fused"],
        "loop_iters_map": d_map["loop_iters"],
        "loop_iters_vmap": d_vmap["loop_iters"],
        "events_per_sec_seed": round(eps_seed, 1),
        "speedup_vs_seed": round(speedup, 2),
        "map_device": CPU_DEVICE,
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
        drain_guard(d_vmap),
        legs_equal_guard(plan["grid"][0], res_v.metrics, res_m.metrics),
    )
    msg = next((f for f in failures if f is not None), None)
    entry = record_smoke(entry, path, device=dev)
    if msg is not None:
        print(msg)
        return SmokeRun(1, entry, results, walls)
    print(f"[smoke] OK: recorded in {path if path is not None else BENCH_FILE}")
    return SmokeRun(0, entry, results, walls)


def smoke(path=None, *, device=None) -> SmokeRun:
    """The card legs on `device`, then the CPU legs, then `finish`."""
    dev = resolve_device(device)
    t_all = time.time()
    banks = smoke_banks()
    results, walls = card_legs(path, device=dev, banks=banks)
    return finish(results, walls, cpu_legs(banks), path, device=dev, t_all=t_all)


def smoke_mesh(path=None, *, device=None) -> int:
    """Leg 1's grid (drained, each seed's bank) under the mesh placement,
    split over every device the census counts (`launch.mesh.local_devices`);
    correctness is the tests' (`tests/test_torch_mesh.py`: the mesh equals
    the map strategy on every leaf). This records throughput and guards
    liveness, with the reference's messages:

    * it fails when the census counts one device (nothing would be split;
      a host with one card fails here). The reference runs the grid before
      it reads the count; the port reads the count first;
    * it fails unless every cell commits (a dead lane means a padding lane
      leaked into a real one, or the split's init broke).

    The mesh keys (``events_mesh``, ``wall_mesh_s``,
    ``events_per_sec_mesh``, ``strategy_resolved_mesh``, ``mesh_devices``,
    ``wall_mesh_total_s``) are merged into the smoke record of the bench
    file; the port has no stored baseline, so nothing is compared with
    one. Returns 0 or 1."""
    dev = resolve_device(device)
    ndev = mesh_device_count("mesh", None, dev)
    if ndev < 2:
        print(f"[smoke] MESH REGRESSION: only {ndev} device visible — nothing was sharded; "
              f"the mesh needs more than one {dev.type} device")
        return 1
    t_all = time.time()
    banks = smoke_banks()
    cells, warmup_s, _ = leg_cells()["grid"]
    t0 = time.time()
    res = common.run_sweep(
        "smoke_mesh", cells, None, SMOKE_T, banks=[banks[c["seed"]] for c in cells],
        horizon_s=SMOKE_HORIZON_S, warmup_s=warmup_s, strategy="mesh", path=path, device=dev,
    )
    wall = time.time() - t0
    eps_mesh = res.events / max(wall, 1e-9)
    d = res.drain
    print(f"[smoke] mesh: {len(cells)} worlds on {res.mesh_devices} devices, {res.events} "
          f"events, {res.steps} steps, {wall:.3f} s (capture included) -> {eps_mesh:.1f} "
          f"events/sec (strategy_resolved={res.strategy_resolved}, drain hit "
          f"{d['drain_hit_rate']:.4f}, mean window {d['mean_window_len']})")
    entry = dict(load_bench(path).get("smoke", {}))
    entry.update({
        "events_mesh": res.events,
        "wall_mesh_s": round(wall, 2),
        "events_per_sec_mesh": round(eps_mesh, 1),
        "strategy_resolved_mesh": res.strategy_resolved,
        "mesh_devices": res.mesh_devices,
        "wall_mesh_total_s": round(time.time() - t_all, 2),
    })
    record_smoke(entry, path, device=dev)
    commits = [m["commits"] for m in res.metrics]
    if any(c == 0 for c in commits):
        print(f"[smoke] MESH REGRESSION: commits={commits} — a sharded lane went dead (padding "
              f"leaked into a real lane or sharded init broke)")
        return 1
    print(f"[smoke] OK: recorded mesh smoke in {path if path is not None else BENCH_FILE}")
    return 0


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
