"""The paper's figure sweeps through the port, the counterpart of the
reference's `benchmarks/figures.py`: one function per paper table / figure,
with the reference's names, `quick` semantics, cells, banks, tags,
horizons, warmups and row keys.

Each figure is a list of `Sweep`s (``<fig>_sweeps(quick)``: tag, cells,
bank or banks, terminals, horizon and warmup) and the row code that turns
their `RunResult`s into the figure's payload, printed line by line as the
reference prints it and saved as ``results/bench_torch/<name>.json``. Every
sweep runs through `common.run_sweep` (`Simulator.run_grid` on the card's
captured lockstep lanes unless `Options` says otherwise); fig11's online
half is a single-lane `Simulator.run` / `with_states` / `resume` chain for
each preset (`fig11_online`), since each chain's next horizon is its own
clock + 8 s.

`Options` carries what the reference's functions do not take: the device
(None: the card, raising without one), a horizon cut (`horizon_s`, with the
warmup cut to `warmup_s` where the figure's own is longer; fig18's 0 stays
0), whether to record the bench file and save the payload, and a log of
each sweep's lanes, steps, events and seconds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.bench.common import DEFAULT_RTT, run_sweep, save, summary_line, ycsb_bank
from repro_torch.core import workloads
from repro_torch.core.engine import (
    INF_US,
    KIND_CRASH,
    KIND_DEGRADE,
    KIND_PARTITION,
    MW,
    Simulator,
    batch,
    drain_stats,
    latency_cdf,
    make_world,
)

QUICK_T = 48  # default terminals for sweeps


@dataclasses.dataclass
class Sweep:
    """One `run_sweep` call of a figure, as the reference makes it."""

    tag: str
    cells: list
    bank: Any  # the Bank every cell shares, or None with `banks`
    terminals: int
    banks: list | None = None
    horizon_s: float = 10.0
    warmup_s: float = 2.0

    def cut(self, horizon_s: float, warmup_s: float) -> "Sweep":
        """This sweep at another horizon, its warmup no longer than
        `warmup_s` (a warmup of 0 stays 0)."""
        return dataclasses.replace(self, horizon_s=horizon_s,
                                   warmup_s=min(self.warmup_s, warmup_s))


@dataclasses.dataclass
class Options:
    """How a figure runs: `device` (None: the card), a horizon cut
    (`horizon_s` None: the figure's own; the warmup then at most
    `warmup_s`), `record` (each sweep in the port's bench file), `save`
    (the payload under ``results/bench_torch``). `log` gets one dict a
    sweep."""

    device: Any = None
    horizon_s: float | None = None
    warmup_s: float = 0.5
    record: bool = True
    save: bool = True
    log: list = dataclasses.field(default_factory=list)

    def sweep(self, s: Sweep) -> Sweep:
        return s if self.horizon_s is None else s.cut(self.horizon_s, self.warmup_s)


def run(s: Sweep, opts: Options):
    """Run one sweep (cut as `opts` says) through `run_sweep`; log its
    lanes, steps, events, wall and capture seconds. Returns the RunResult."""
    s = opts.sweep(s)
    res = run_sweep(s.tag, s.cells, s.bank, s.terminals, banks=s.banks, horizon_s=s.horizon_s,
                    warmup_s=s.warmup_s, record=opts.record, device=opts.device)
    opts.log.append(dict(tag=s.tag, lanes=len(s.cells), steps=res.steps, events=res.events,
                         wall_s=res.wall_s, capture_s=batch.run.capture_s,
                         horizon_s=s.horizon_s, warmup_s=s.warmup_s))
    return res


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _figure(name: str, sweeps: list, rows, opts: Options | None) -> list:
    """Run `sweeps` in order, each through `rows(sweep, result)` (which
    prints the figure's lines and returns its rows); save the payload."""
    opts = opts if opts is not None else Options()
    out = []
    for s in sweeps:
        out += rows(s, run(s, opts))
    if opts.save:
        save(name, out)
    return out


def _banked(pairs) -> tuple[list, list]:
    """[(cell, bank), ...] -> (cells, banks)."""
    return [c for c, _ in pairs], [b for _, b in pairs]


# ---------------------------------------------------------------------------
# fig1: centralized-txn latency vs the other data source's RTT
# ---------------------------------------------------------------------------


def fig1_sweeps(quick=True) -> list:
    taus = (10, 25, 50, 75, 100)
    pairs = []
    for contention, theta in (("LC", 0.3), ("MC", 0.9)):
        bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=0.2, num_ds=2, records=500_000)
        for tau2 in taus:
            pairs.append((dict(preset="ssp", rtt_ms=(10.0, float(tau2)), contention=contention,
                               tau2_ms=tau2), bank))
    cells, banks = _banked(pairs)
    return [Sweep("fig1", cells, None, QUICK_T, banks=banks, horizon_s=8.0)]


def _fig1_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(contention=c["contention"], tau2_ms=c["tau2_ms"],
                        p50_cen=m["p50_centralized_ms"], avg=m["avg_latency_ms"],
                        tps=m["throughput_tps"]))
        print(summary_line(f"fig1 {c['contention']} tau2={c['tau2_ms']}", m))
    return out


def fig1_motivation(quick=True, *, opts=None):
    """Centralized-txn latency vs the *other* data source's RTT (Fig 1b)."""
    return _figure("fig1_motivation", fig1_sweeps(quick), _fig1_rows, opts)


# ---------------------------------------------------------------------------
# fig5: throughput vs terminals (YCSB and TPC-C)
# ---------------------------------------------------------------------------


def fig5_sweeps(quick=True) -> list:
    out = []
    for T in (16, 32, 64) if quick else (16, 32, 64, 128):
        bank = ycsb_bank(T, theta=0.9, dist_ratio=0.2)
        cells = [dict(preset=p) for p in ("ssp", "ssp-local", "scalardb", "geotp")]
        out.append(Sweep(f"fig5_ycsb_T{T}", cells, bank, T))
    for T in (16, 32):
        tcfg = workloads.TPCCConfig(num_ds=4, warehouses_per_node=16, dist_ratio=0.2)
        bank, _ = workloads.make_tpcc_bank(tcfg, T, 256)
        out.append(Sweep(f"fig5_tpcc_T{T}", [dict(preset=p) for p in ("ssp", "geotp")], bank, T))
    return out


def _fig5_rows(s, res):
    bench = "tpcc" if s.tag.startswith("fig5_tpcc") else "ycsb"
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(bench=bench, terminals=s.terminals, **m))
        print(summary_line(f"fig5 {bench} T={s.terminals} {c['preset']}", m))
    return out


def fig5_overall(quick=True, *, opts=None):
    """Throughput vs #terminals, GeoTP vs SSP/SSP-local/ScalarDB (YCSB+TPCC)."""
    return _figure("fig5_overall", fig5_sweeps(quick), _fig5_rows, opts)


# ---------------------------------------------------------------------------
# fig7: distributed-txn ratio x contention, with QURO and Chiller
# ---------------------------------------------------------------------------


def fig7_sweeps(quick=True) -> list:
    ratios = (0.0, 0.2, 0.6, 1.0) if quick else (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    pairs = []
    for level, theta in (("low", 0.3), ("medium", 0.9), ("high", 1.2)):
        for dr in ratios:
            bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=dr)
            bank_q = ycsb_bank(QUICK_T, theta=theta, dist_ratio=dr, quro=True)
            for preset in ("ssp", "ssp-local", "chiller", "geotp"):
                pairs.append((dict(preset=preset, level=level, dist_ratio=dr), bank))
            pairs.append((dict(preset="quro", level=level, dist_ratio=dr), bank_q))
    cells, banks = _banked(pairs)
    return [Sweep("fig7", cells, None, QUICK_T, banks=banks)]


def _fig7_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(level=c["level"], dist_ratio=c["dist_ratio"], **m))
        print(summary_line(f"fig7 {c['level']} dr={c['dist_ratio']} {c['preset']}", m))
    return out


def fig7_dist_ratio(quick=True, *, opts=None):
    """Vary distributed-txn ratio under 3 contention levels + QURO/Chiller."""
    return _figure("fig7_dist_ratio", fig7_sweeps(quick), _fig7_rows, opts)


# ---------------------------------------------------------------------------
# fig8: latency CDFs at 60% distributed transactions
# ---------------------------------------------------------------------------


def fig8_sweeps(quick=True) -> list:
    pairs = []
    for level, theta in (("low", 0.3), ("medium", 0.9), ("high", 1.2)):
        bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=0.6)
        for preset in ("ssp", "ssp-local", "geotp"):
            pairs.append((dict(preset=preset, level=level), bank))
    cells, banks = _banked(pairs)
    return [Sweep("fig8", cells, None, QUICK_T, banks=banks)]


def _fig8_rows(s, res):
    out = []
    for i, (c, m) in enumerate(zip(s.cells, res.metrics)):
        st = res.world(i)
        edges, cdf = latency_cdf(_host(st.hist_all))
        _, cdf_cen = latency_cdf(_host(st.hist_cen))
        out.append(dict(level=c["level"], preset=c["preset"], p99=m["p99_ms"], p999=m["p999_ms"],
                        edges_ms=edges.tolist(), cdf=cdf.tolist(),
                        cdf_centralized=cdf_cen.tolist(), tps=m["throughput_tps"]))
        print(summary_line(f"fig8 {c['level']} {c['preset']}", m))
    return out


def fig8_latency_cdf(quick=True, *, opts=None):
    """Latency CDFs at 60% distributed txns (turning points, p99)."""
    return _figure("fig8_latency_cdf", fig8_sweeps(quick), _fig8_rows, opts)


# ---------------------------------------------------------------------------
# fig9: TPC-C Payment-only and NewOrder-only
# ---------------------------------------------------------------------------


def fig9_sweeps(quick=True) -> list:
    pairs = []
    for tname, ttype in (("payment", workloads.TPCC_PAYMENT),
                         ("neworder", workloads.TPCC_NEWORDER)):
        tcfg = workloads.TPCCConfig(num_ds=4, warehouses_per_node=16, dist_ratio=0.2,
                                    only_type=ttype)
        bank, _ = workloads.make_tpcc_bank(tcfg, QUICK_T, 256)
        for preset in ("ssp", "chiller", "geotp"):
            pairs.append((dict(preset=preset, txn=tname), bank))
    cells, banks = _banked(pairs)
    return [Sweep("fig9", cells, None, QUICK_T, banks=banks)]


def _fig9_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(txn=c["txn"], **m))
        print(summary_line(f"fig9 {c['txn']} {c['preset']}", m))
    return out


def fig9_tpcc(quick=True, *, opts=None):
    """TPC-C Payment-only and NewOrder-only (contention contrast)."""
    return _figure("fig9_tpcc", fig9_sweeps(quick), _fig9_rows, opts)


# ---------------------------------------------------------------------------
# fig10: mean / std of the WAN latency
# ---------------------------------------------------------------------------


def fig10_sweeps(quick=True) -> list:
    bank = ycsb_bank(QUICK_T, theta=0.9, dist_ratio=0.2)
    cells = []
    for mean in (20, 40, 80):  # std fixed ~ mean/2: lats mean±std
        rtt = (0.0, mean / 2.0, float(mean), mean * 1.5)
        for preset in ("ssp", "geotp"):
            cells.append(dict(preset=preset, rtt_ms=rtt, sweep="mean", mean_ms=mean))
    for std in (0, 20, 40):  # mean fixed 40
        rtt = (0.0, 40.0 - std / 2, 40.0, 40.0 + std)
        for preset in ("ssp", "geotp"):
            cells.append(dict(preset=preset, rtt_ms=rtt, sweep="std", std_ms=std))
    return [Sweep("fig10", cells, bank, QUICK_T)]


def _fig10_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        label = {k: c[k] for k in ("sweep", "mean_ms", "std_ms") if k in c}
        out.append(dict(**label, **m))
        print(summary_line(f"fig10 {c['sweep']}={c.get('mean_ms', c.get('std_ms'))} "
                           f"{c['preset']}", m))
    return out


def fig10_network(quick=True, *, opts=None):
    """Sweep mean / std of WAN latency (Fig 10)."""
    return _figure("fig10_network", fig10_sweeps(quick), _fig10_rows, opts)


# ---------------------------------------------------------------------------
# fig11: random latencies, then online re-configuration through resume
# ---------------------------------------------------------------------------

FIG11_SEGMENTS = ((0, 27, 73, 251), (0, 120, 40, 200), (0, 27, 200, 80), (0, 60, 60, 251))
FIG11_HORIZON_S, FIG11_WARMUP_S = 8.0, 1.0  # the online chain's first segment
FIG11_SEGMENT_S = 8.0  # each later segment: resume to now / 1e6 + 8.0, warmup 0


def fig11_bank():
    return ycsb_bank(QUICK_T, theta=0.9, dist_ratio=0.6)


def fig11_sweeps(quick=True, bank=None) -> list:
    """fig11's random half (the online half is `fig11_online`)."""
    rng = np.random.default_rng(7)
    trials = 5 if quick else 20
    bank = bank if bank is not None else fig11_bank()
    cells = []
    for trial in range(trials):
        rtt = tuple(float(x) for x in [0.0, *sorted(rng.uniform(10, 250, 3))])
        for preset in ("ssp", "geotp"):
            cells.append(dict(preset=preset, rtt_ms=rtt, trial=trial))
    return [Sweep("fig11_random", cells, bank, QUICK_T, horizon_s=8.0)]


def fig11_online(bank, *, device=None, horizon_s=FIG11_HORIZON_S, warmup_s=FIG11_WARMUP_S,
                 segment_s=FIG11_SEGMENT_S, on_segment=None) -> list:
    """fig11's online adaptivity: for each preset a single-lane chain, the
    first segment through `Simulator.run`, each later one `with_states`
    (tau_true set to the segment's RTTs) then `resume` to its own clock +
    `segment_s`, warmup 0; a resumed segment's throughput is its new
    commits over `segment_s`. `on_segment(preset, i, rtt, res, metrics)`
    is called after each segment. Returns the payload's online rows."""
    sim = Simulator.from_bank(bank, terminals=QUICK_T, horizon_s=horizon_s, warmup_s=warmup_s,
                              device=device)
    out = []
    for preset in ("ssp", "geotp"):
        res = None
        tps = []
        for i, rtt in enumerate(FIG11_SEGMENTS):
            if res is None:
                res = sim.run(make_world(preset, tuple(map(float, rtt)), jitter_milli=30), bank)
                m = res.metrics[0]
            else:
                # continue from the prior state with new true latencies
                tau = torch.tensor([[int(r * 1000) for r in rtt]], dtype=torch.int32,
                                   device=sim.device)
                res = res.with_states(res.states._replace(tau_true=tau))
                base_commits = int(res.states.commits)
                res = sim.resume(res, horizon_s=int(res.states.now) / 1e6 + segment_s,
                                 warmup_s=0.0)
                m = dict(res.metrics[0])
                m["throughput_tps"] = (int(res.states.commits) - base_commits) / segment_s
            if on_segment is not None:
                on_segment(preset, i, rtt, res, m)
            tps.append(m["throughput_tps"])
            out.append(dict(mode="online", preset=preset, segment=i, rtt=rtt,
                            tps=m["throughput_tps"]))
        print(f"fig11 online {preset}: tps per segment {['%.0f' % t for t in tps]}")
    return out


def fig11_dynamic(quick=True, *, opts=None):
    """(a) random latencies x N trials; (b) online latency re-configuration."""
    opts = opts if opts is not None else Options()
    bank = fig11_bank()
    (s,) = fig11_sweeps(quick, bank)
    ms = run(s, opts).metrics
    out = [dict(mode="random", trial=c["trial"], rtt=c["rtt_ms"], **m)
           for c, m in zip(s.cells, ms)]
    print(f"fig11 random: {len(s.cells) // 2} trials x 2 presets done")
    if opts.horizon_s is None:
        kw = {}
    else:
        kw = dict(horizon_s=opts.horizon_s, warmup_s=min(FIG11_WARMUP_S, opts.warmup_s),
                  segment_s=opts.horizon_s)
    seen = {}

    def log(preset, i, rtt, res, m):
        # each segment's own events: the chain's counters are cumulative
        events, seen[preset] = m["events"] - seen.get(preset, 0), m["events"]
        opts.log.append(dict(tag=f"fig11_online_{preset}_{i}", lanes=1, steps=res.steps,
                             events=events, wall_s=res.wall_s, capture_s=batch.run.capture_s,
                             horizon_s=res.cfg.horizon_us / 1e6,
                             warmup_s=res.cfg.warmup_us / 1e6))

    out += fig11_online(bank, device=opts.device, on_segment=log, **kw)
    if opts.save:
        save("fig11_dynamic", out)
    return out


# ---------------------------------------------------------------------------
# fig12: the O1 / O1-O2 / O1-O3 ablation across skew (the 17.7x figure)
# ---------------------------------------------------------------------------


def fig12_sweeps(quick=True) -> list:
    thetas = (0.1, 0.5, 0.9, 1.1, 1.3) if quick else (0.1, 0.3, 0.5, 0.7, 0.9, 1.1, 1.3, 1.5, 1.7)
    pairs = []
    for theta in thetas:
        bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=0.5)
        for preset in ("ssp", "geotp-o1", "geotp-o1o2", "geotp"):
            pairs.append((dict(preset=preset, theta=theta), bank))
    cells, banks = _banked(pairs)
    return [Sweep("fig12", cells, None, QUICK_T, banks=banks)]


def _fig12_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(theta=c["theta"], **m))
        print(summary_line(f"fig12 theta={c['theta']} {c['preset']}", m))
    return out


def fig12_ablation(quick=True, *, opts=None):
    """O1 / O1-O2 / O1-O3 vs SSP across skew (the 17.7x figure)."""
    return _figure("fig12_ablation", fig12_sweeps(quick), _fig12_rows, opts)


# ---------------------------------------------------------------------------
# table1: heterogeneous deployments
# ---------------------------------------------------------------------------

# engine profiles: MySQL exec 1.0x; PG slightly slower exec in the model
TABLE1_PROFILES = {
    "S1-mysql": (1000, 1000, 1000, 1000),
    "S2-postgres": (1400, 1400, 1400, 1400),
    "S3-mixed": (1000, 1400, 1000, 1400),
}


def table1_sweeps(quick=True) -> list:
    pairs = []
    for sname, scale in TABLE1_PROFILES.items():
        for dr in (0.25, 0.75):
            bank = ycsb_bank(QUICK_T, theta=0.9, dist_ratio=dr)
            for preset in ("ssp", "geotp"):
                pairs.append((dict(preset=preset, exec_scale_milli=scale, scenario=sname,
                                   dist_ratio=dr), bank))
    cells, banks = _banked(pairs)
    return [Sweep("table1", cells, None, QUICK_T, banks=banks)]


def _table1_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(scenario=c["scenario"], dist_ratio=c["dist_ratio"], **m))
        print(summary_line(f"table1 {c['scenario']} dr={c['dist_ratio']} {c['preset']}", m))
    return out


def table1_heterogeneous(quick=True, *, opts=None):
    """MySQL/PostgreSQL deployment mixes (exec/flush profiles), dr=25/75%."""
    return _figure("table1_heterogeneous", table1_sweeps(quick), _table1_rows, opts)


# ---------------------------------------------------------------------------
# fig13: a distributed-database-style baseline
# ---------------------------------------------------------------------------


def fig13_sweeps(quick=True) -> list:
    pairs = []
    for level, theta in (("low", 0.3), ("medium", 0.9), ("high", 1.2)):
        bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=0.2)
        for preset in ("ssp", "geotp", "yugabyte-like"):
            pairs.append((dict(preset=preset, level=level), bank))
    cells, banks = _banked(pairs)
    return [Sweep("fig13", cells, None, QUICK_T, banks=banks)]


def _fig13_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(level=c["level"], **m))
        print(summary_line(f"fig13 {c['level']} {c['preset']}", m))
    return out


def fig13_yugabyte(quick=True, *, opts=None):
    """Distributed-database-style baseline (async single-shard apply)."""
    return _figure("fig13_yugabyte", fig13_sweeps(quick), _fig13_rows, opts)


# ---------------------------------------------------------------------------
# fig14: transaction length and interactive rounds
# ---------------------------------------------------------------------------


def fig14_sweeps(quick=True) -> list:
    out = []
    for ops in (5, 15, 25):  # txn length changes the op-slot shape: one sweep each
        bank = ycsb_bank(QUICK_T, theta=0.9, dist_ratio=0.2, ops=ops)
        out.append(Sweep(f"fig14_ops{ops}", [dict(preset=p) for p in ("ssp", "geotp")], bank,
                         QUICK_T))
    pairs = []
    for rounds, theta in ((1, 0.3), (2, 0.3), (3, 0.3), (1, 0.9), (2, 0.9), (3, 0.9)):
        bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=0.2, ops=6, rounds=rounds)
        for preset in ("ssp", "geotp"):
            pairs.append((dict(preset=preset, rounds=rounds, theta=theta), bank))
    cells, banks = _banked(pairs)
    out.append(Sweep("fig14_rounds", cells, None, QUICK_T, banks=banks))
    return out


def _fig14_rows(s, res):
    out = []
    if s.tag == "fig14_rounds":
        for c, m in zip(s.cells, res.metrics):
            out.append(dict(sweep="rounds", rounds=c["rounds"], theta=c["theta"], **m))
            print(summary_line(f"fig14 rounds={c['rounds']} th={c['theta']} {c['preset']}", m))
        return out
    ops = int(s.tag.removeprefix("fig14_ops"))
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(sweep="length", ops=ops, **m))
        print(summary_line(f"fig14 ops={ops} {c['preset']}", m))
    return out


def fig14_txn_length(quick=True, *, opts=None):
    """Transaction length 5..25 ops; interactive rounds 1..3."""
    return _figure("fig14_txn_length", fig14_sweeps(quick), _fig14_rows, opts)


# ---------------------------------------------------------------------------
# fig15: two middleware placements
# ---------------------------------------------------------------------------


def fig15_sweeps(quick=True) -> list:
    bank = ycsb_bank(QUICK_T, theta=0.9, dist_ratio=0.2)
    cells = []
    for dm, rtt in (("dm1-beijing", (0.0, 27.0, 73.0, 251.0)),
                    ("dm2-london", (251.0, 226.0, 175.0, 0.0))):
        for preset in ("ssp", "geotp"):
            cells.append(dict(preset=preset, rtt_ms=rtt, dm=dm))
    return [Sweep("fig15", cells, bank, QUICK_T)]


def _fig15_rows(s, res):
    out = []
    for c, m in zip(s.cells, res.metrics):
        out.append(dict(dm=c["dm"], **m))
        print(summary_line(f"fig15 {c['dm']} {c['preset']}", m))
    return out


def fig15_multiregion(quick=True, *, opts=None):
    """Two middleware placements (Beijing DM vs London DM)."""
    return _figure("fig15_multiregion", fig15_sweeps(quick), _fig15_rows, opts)


# ---------------------------------------------------------------------------
# fig16 / fig17: crashes, then typed link faults with replicas
# ---------------------------------------------------------------------------

# two full crash / recovery cycles inside the horizon (µs timestamps)
FIG16_CRASHES = ((2_000_000, 0, 4_000_000), (5_000_000, 2, 6_500_000))
_PAD = (INF_US, KIND_CRASH, 0, 0, INF_US, 0)
# mw cut of ds1 (failover window), 4x degrade of the ds2 link, mesh cut
FIG17_PARTITIONS = (
    (1_500_000, KIND_PARTITION, MW, 1, 4_000_000, 0),
    (2_000_000, KIND_DEGRADE, MW, 2, 5_000_000, 4_000),
    (5_500_000, KIND_PARTITION, 1, 2, 6_500_000, 0),
)
# pure degrade cycles: nothing severed, latency inflation only
FIG17_DEGRADES = (
    (1_500_000, KIND_DEGRADE, MW, 1, 4_500_000, 6_000),
    (3_000_000, KIND_DEGRADE, MW, 2, 6_000_000, 4_000),
    _PAD,
)
FIG17_REPLICAS = dict(replica_tau=(30_000,) * 4, repl_lag_us=500_000)


def fig16_sweeps(quick=True) -> list:
    bank = ycsb_bank(QUICK_T, theta=0.9, dist_ratio=0.2)
    clean = ((INF_US, 0, INF_US),) * len(FIG16_CRASHES)
    cells = [dict(preset=p, faults=sched, schedule=label)
             for label, sched in (("crashes", FIG16_CRASHES), ("fault-free", clean))
             for p in ("ssp", "geotp")]
    return [Sweep("fig16", cells, bank, QUICK_T, horizon_s=8.0 if quick else 20.0,
                  warmup_s=1.0)]


def _fig16_rows(s, res):
    out = []
    for i, (c, m) in enumerate(zip(s.cells, res.metrics)):
        d = drain_stats(res.world(i), horizon_us=res.cfg.horizon_us)
        out.append(dict(schedule=c["schedule"], availability=d["availability"],
                        abort_causes=d["abort_causes"],
                        commits_during_fault=d["commits_during_fault"], **m))
        print(summary_line(f"fig16 {c['schedule']} {c['preset']}", m)
              + f" avail={d['availability']:.4f}"
              f" crash_aborts={d['abort_causes']['crash']}"
              f" goodput_in_fault={d['commits_during_fault']}")
    return out


def fig16_faults(quick=True, *, opts=None):
    """Fault sweep: GeoTP vs coordinated-prepare (SSP) under deterministic
    data-source crashes, against a fault-free control with the same
    (all-pad) schedule shape."""
    return _figure("fig16_faults", fig16_sweeps(quick), _fig16_rows, opts)


def fig17_sweeps(quick=True) -> list:
    bank = ycsb_bank(QUICK_T, theta=0.9, dist_ratio=0.2)
    clean = (_PAD,) * len(FIG17_PARTITIONS)
    cells = [dict(preset=p, faults=sched, schedule=label, **FIG17_REPLICAS)
             for label, sched in (("partitions", FIG17_PARTITIONS),
                                  ("degrades", FIG17_DEGRADES), ("fault-free", clean))
             for p in ("ssp", "geotp")]
    return [Sweep("fig17", cells, bank, QUICK_T, horizon_s=8.0 if quick else 20.0,
                  warmup_s=1.0)]


def _fig17_rows(s, res):
    out = []
    for i, (c, m) in enumerate(zip(s.cells, res.metrics)):
        d = drain_stats(res.world(i), horizon_us=res.cfg.horizon_us)
        out.append(dict(schedule=c["schedule"], availability=d["availability"],
                        link_downtime_us=d["link_downtime_us"], failovers=d["failovers"],
                        stale_reads=d["stale_reads"], max_staleness_us=d["max_staleness_us"],
                        abort_causes=d["abort_causes"],
                        commits_during_fault=d["commits_during_fault"], **m))
        print(summary_line(f"fig17 {c['schedule']} {c['preset']}", m)
              + f" avail={d['availability']:.4f}"
              f" failovers={d['failovers']}"
              f" stale_reads={d['stale_reads']}")
    return out


def fig17_partitions(quick=True, *, opts=None):
    """Link-fault sweep: GeoTP vs SSP under typed link faults (an asymmetric
    middleware partition with replica failover and stale reads, a degraded
    link, a mesh partition) against a fault-free control of the same shape."""
    return _figure("fig17_partitions", fig17_sweeps(quick), _fig17_rows, opts)


# ---------------------------------------------------------------------------
# fig18: the protocol zoo head to head
# ---------------------------------------------------------------------------


def fig18_sweeps(quick=True) -> list:
    scales = (0.5, 1.0) if quick else (0.5, 1.0, 2.0)
    skews = (0, 100_000, 200_000)  # vs the tiga preset's 150 ms slack
    pairs = []
    for level, theta in (("uniform", 0.0), ("hotspot", 1.2)):
        bank = ycsb_bank(QUICK_T, theta=theta, dist_ratio=0.5)
        for scale in scales:
            rtt = tuple(r * scale for r in DEFAULT_RTT)
            for preset in ("ssp", "geotp", "fastc", "opta"):
                pairs.append((dict(preset=preset, rtt_ms=rtt, level=level, rtt_scale=scale,
                                   clock_skew_us=0), bank))
            for skew in skews:
                pairs.append((dict(preset="tiga", rtt_ms=rtt, level=level, rtt_scale=scale,
                                   clock_skew_us=skew), bank))
    cells, banks = _banked(pairs)
    return [Sweep("fig18", cells, None, QUICK_T, banks=banks, horizon_s=8.0, warmup_s=0.0)]


def _fig18_rows(s, res):
    out = []
    for i, (c, m) in enumerate(zip(s.cells, res.metrics)):
        d = drain_stats(res.world(i), horizon_us=res.cfg.horizon_us)
        finished = max(m["commits"] + m["aborts"], 1)
        out.append(dict(level=c["level"], rtt_scale=c["rtt_scale"],
                        clock_skew_us=c["clock_skew_us"], wan_rounds=d["wan_rounds"],
                        wan_per_txn=round(d["wan_rounds"] / finished, 3),
                        fast_commits=d["fast_commits"],
                        fast_rate=round(d["fast_commits"] / max(m["commits"], 1), 4), **m))
        print(summary_line(f"fig18 {c['level']} x{c['rtt_scale']} "
                           f"skew={c['clock_skew_us'] // 1000}ms {c['preset']}", m)
              + f" wan/txn={out[-1]['wan_per_txn']:5.2f}"
              f" fast={out[-1]['fast_rate']:.0%}")
    return out


def fig18_protocols(quick=True, *, opts=None):
    """Protocol-zoo head-to-head: GeoTP vs FASTC vs TIGA vs OPTA vs SSP
    across contention x RTT scale, with a synchronized-clock skew axis for
    TIGA: WAN rounds per finished transaction, fast-path commit rate, and
    the abort / latency trade-off. Warmup 0, so the receive-side
    `wan_rounds` counter and the commit / abort tallies cover one span."""
    return _figure("fig18_protocols", fig18_sweeps(quick), _fig18_rows, opts)


ALL_FIGURES = [
    fig1_motivation,
    fig5_overall,
    fig7_dist_ratio,
    fig8_latency_cdf,
    fig9_tpcc,
    fig10_network,
    fig11_dynamic,
    fig12_ablation,
    table1_heterogeneous,
    fig13_yugabyte,
    fig14_txn_length,
    fig15_multiregion,
    fig16_faults,
    fig17_partitions,
    fig18_protocols,
]

# each figure's sweeps and row code, by the figure function's name (fig11's
# online chain is `fig11_online`)
SWEEPS = {
    "fig1_motivation": (fig1_sweeps, _fig1_rows),
    "fig5_overall": (fig5_sweeps, _fig5_rows),
    "fig7_dist_ratio": (fig7_sweeps, _fig7_rows),
    "fig8_latency_cdf": (fig8_sweeps, _fig8_rows),
    "fig9_tpcc": (fig9_sweeps, _fig9_rows),
    "fig10_network": (fig10_sweeps, _fig10_rows),
    "fig11_dynamic": (fig11_sweeps, None),
    "fig12_ablation": (fig12_sweeps, _fig12_rows),
    "table1_heterogeneous": (table1_sweeps, _table1_rows),
    "fig13_yugabyte": (fig13_sweeps, _fig13_rows),
    "fig14_txn_length": (fig14_sweeps, _fig14_rows),
    "fig15_multiregion": (fig15_sweeps, _fig15_rows),
    "fig16_faults": (fig16_sweeps, _fig16_rows),
    "fig17_partitions": (fig17_sweeps, _fig17_rows),
    "fig18_protocols": (fig18_sweeps, _fig18_rows),
}


def timed(fn, quick=True, opts=None) -> dict:
    """Run one figure function; returns its wall seconds and its sweeps'
    lanes, steps and events (from `opts.log`)."""
    opts = opts if opts is not None else Options()
    n = len(opts.log)
    t0 = time.perf_counter()
    fn(quick, opts=opts)
    wall = time.perf_counter() - t0
    log = opts.log[n:]
    return dict(name=fn.__name__, wall_s=wall, sweeps=len(log),
                lanes=sum(e["lanes"] for e in log), steps=sum(e["steps"] for e in log),
                events=sum(e["events"] for e in log))
