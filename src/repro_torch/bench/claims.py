"""The paper's claim checks, the port's counterpart of the reference's
`benchmarks/claims.py` and of `benchmarks/run.py::validate`.

The port keeps its own copy (it imports nothing of the reference, not even
that module's `json` / `pathlib` helpers). `ClaimSet` reads the figure
payloads that `repro_torch.bench.figures` writes under
``results/bench_torch/`` by default; `validate` runs every figure's checks
over them and returns the (name, ok, detail) verdicts the claim summary
prints.
"""

from __future__ import annotations

import json
import pathlib

RESULTS_DIR = "results/bench_torch"


class ClaimSet:
    """Accumulates claim checks against one results directory.

    `load(name)` reads `<results_dir>/<name>.json` (None when the figure has
    not been run — validators skip silently, matching the historical
    behavior); `add(name, ok, detail)` records one verdict. `checks` is the
    list of (name, bool(ok), detail) triples the summary prints.
    """

    def __init__(self, results_dir=RESULTS_DIR):
        self.dir = pathlib.Path(results_dir)
        self.checks: list = []

    def load(self, name: str):
        f = self.dir / f"{name}.json"
        if not f.exists():
            return None
        with open(f) as fh:
            return json.load(fh)

    def add(self, name: str, ok, detail) -> None:
        self.checks.append((name, bool(ok), detail))

    @property
    def n_ok(self) -> int:
        return sum(ok for _, ok, _ in self.checks)


def rows_by(rows, key: str = "preset", **filters) -> dict:
    """Index rows by `key` after an equality filter on the other labels.

    The figure payloads are flat lists of per-cell dicts; nearly every claim
    starts by slicing one schedule/level/theta out and keying the survivors
    by preset: ``rows_by(fig16, schedule="crashes")`` ->
    ``{"ssp": row, "geotp": row}``. Later rows win on duplicate keys (the
    payloads carry one row per (filter, key) combination).
    """
    out = {}
    for r in rows:
        if all(r.get(k) == v for k, v in filters.items()):
            out[r[key]] = r
    return out


def values_over(rows, axis: str, value_key: str, **filters) -> list:
    """The `value_key` series ordered by the `axis` label (filtered first).

    For monotonicity claims: ``values_over(fig18_rows, "clock_skew_us",
    "fast_rate", preset="tiga", rtt_scale=1.0)`` -> the fast-path rate as
    the skew axis grows.
    """
    picked = [r for r in rows if all(r.get(k) == v for k, v in filters.items())]
    return [r[value_key] for r in sorted(picked, key=lambda r: r[axis])]


def ratio(num, den, eps: float = 1e-9) -> float:
    """num/den with the zero-denominator guard every throughput claim uses."""
    return num / max(den, eps)


def non_increasing(series, tol: float = 0.0) -> bool:
    """True when each element is <= its predecessor (+tol absolute slack)."""
    return all(b <= a + tol for a, b in zip(series, series[1:]))


def validate(results_dir=RESULTS_DIR) -> list:
    """Check the paper's qualitative claims against the figure payloads
    under `results_dir`: the reference's checks (`benchmarks/run.py::
    validate`), with the same names, order and details. A figure whose
    payload is missing adds no check. Returns [(name, ok, detail)]."""
    cs = ClaimSet(results_dir)
    checks, load, add = cs.checks, cs.load, cs.add

    fig5 = load("fig5_overall")
    if fig5:
        ycsb = [r for r in fig5 if r["bench"] == "ycsb"]
        ratios = []
        for T in sorted({r["terminals"] for r in ycsb}):
            by = {r["preset"]: r for r in ycsb if r["terminals"] == T}
            if "geotp" in by and "ssp" in by:
                ratios.append(ratio(by["geotp"]["throughput_tps"], by["ssp"]["throughput_tps"]))
        add("fig5: GeoTP > SSP (YCSB, all terminal counts)", all(r > 1.0 for r in ratios),
            f"ratios={[round(r,2) for r in ratios]}")
        sdb = [r for r in ycsb if r["preset"] == "scalardb"]
        ssp = [r for r in ycsb if r["preset"] == "ssp"]
        if sdb and ssp:
            add("fig5: ScalarDB-style slowest", sdb[0]["throughput_tps"] < ssp[0]["throughput_tps"],
                f"scalardb={sdb[0]['throughput_tps']:.0f} ssp={ssp[0]['throughput_tps']:.0f}")

    fig7 = load("fig7_dist_ratio")
    if fig7:
        med = [r for r in fig7 if r["level"] == "medium" and r["dist_ratio"] == 0.6]
        by = {r["preset"]: r for r in med}
        if by:
            add("fig7: GeoTP competitive-best at medium contention, 60% distributed",
                by["geotp"]["throughput_tps"] >= 0.95 * max(v["throughput_tps"] for k, v in by.items() if k != "geotp")
                and by["geotp"]["throughput_tps"] > by["ssp"]["throughput_tps"],
                {k: round(v["throughput_tps"]) for k, v in by.items()})
            if "chiller" in by:
                add("fig7: GeoTP >= Chiller within noise (paper: up to 1.6x)",
                    by["geotp"]["throughput_tps"] >= by["chiller"]["throughput_tps"] * 0.95,
                    f"geotp/chiller={by['geotp']['throughput_tps']/max(by['chiller']['throughput_tps'],1e-9):.2f}")

    fig12 = load("fig12_ablation")
    if fig12:
        best = 0.0
        order_ok = []
        for theta in sorted({r["theta"] for r in fig12}):
            by = {r["preset"]: r for r in fig12 if r["theta"] == theta}
            if "geotp" in by and "ssp" in by:
                best = max(best, ratio(by["geotp"]["throughput_tps"], by["ssp"]["throughput_tps"]))
            if 0.5 <= theta <= 1.0 and all(k in by for k in ("ssp", "geotp-o1", "geotp-o1o2")):
                order_ok.append(
                    by["ssp"]["throughput_tps"] <= by["geotp-o1"]["throughput_tps"] * 1.05
                    and by["geotp"]["throughput_tps"]
                    >= 0.9 * max(by["geotp-o1"]["throughput_tps"], by["geotp-o1o2"]["throughput_tps"])
                )
        add("fig12: max GeoTP/SSP speedup (paper: up to 17.7x at its scale)", best > 1.9, f"max ratio={best:.1f}x")
        add("fig12: O1 dominates SSP; O1~O3 competitive with best ablation (theta 0.5-1.0)",
            all(order_ok) and order_ok, order_ok)

    fig13 = load("fig13_yugabyte")
    if fig13:
        by_lvl = {}
        for r in fig13:
            by_lvl.setdefault(r["level"], {})[r["preset"]] = r
        if "high" in by_lvl and "geotp" in by_lvl["high"]:
            add("fig13: GeoTP beats distributed-DB baseline at high contention",
                by_lvl["high"]["geotp"]["throughput_tps"] > by_lvl["high"]["yugabyte-like"]["throughput_tps"],
                {k: round(v["throughput_tps"]) for k, v in by_lvl["high"].items()})
        if "low" in by_lvl and "yugabyte-like" in by_lvl["low"]:
            add("fig13: distributed-DB baseline competitive at low contention",
                by_lvl["low"]["yugabyte-like"]["throughput_tps"] > by_lvl["low"]["ssp"]["throughput_tps"],
                {k: round(v["throughput_tps"]) for k, v in by_lvl["low"].items()})

    fig14 = load("fig14_txn_length")
    if fig14:
        rounds = [r for r in fig14 if r.get("sweep") == "rounds" and r.get("theta") == 0.3]
        by = {}
        for r in rounds:
            by.setdefault(r["rounds"], {})[r["preset"]] = r
        if 3 in by and 1 in by:
            g3 = by[3]["geotp"]["throughput_tps"] / max(by[3]["ssp"]["throughput_tps"], 1e-9)
            add("fig14: GeoTP advantage persists with interactive rounds", g3 > 1.0, f"3-round ratio={g3:.2f}")

    fig16 = load("fig16_faults")
    if fig16:
        faulted = rows_by(fig16, schedule="crashes")
        clean = rows_by(fig16, schedule="fault-free")
        if faulted and clean:
            add("fig16: injected outages show up in availability",
                all(r["availability"] < 1.0 for r in faulted.values())
                and all(r["availability"] == 1.0 for r in clean.values()),
                {k: round(v["availability"], 4) for k, v in faulted.items()})
            add("fig16: crash-cause aborts only under the crash schedule",
                all(r["abort_causes"]["crash"] > 0 for r in faulted.values())
                and all(r["abort_causes"]["crash"] == 0 for r in clean.values()),
                {k: v["abort_causes"]["crash"] for k, v in faulted.items()})
            add("fig16: service survives the outages (commits on every cell)",
                all(r["commits"] > 0 for r in faulted.values()),
                {k: v["commits"] for k, v in faulted.items()})
            if "geotp" in faulted and "ssp" in faulted:
                add("fig16: GeoTP >= SSP throughput under crashes",
                    faulted["geotp"]["throughput_tps"]
                    >= faulted["ssp"]["throughput_tps"],
                    {k: round(v["throughput_tps"]) for k, v in faulted.items()})

    fig17 = load("fig17_partitions")
    if fig17:
        parts = rows_by(fig17, schedule="partitions")
        degr = rows_by(fig17, schedule="degrades")
        clean = rows_by(fig17, schedule="fault-free")
        if parts and clean:
            add("fig17: partitions charge availability, fault-free does not",
                all(r["availability"] < 1.0 for r in parts.values())
                and all(r["availability"] == 1.0 for r in clean.values()),
                {k: round(v["availability"], 4) for k, v in parts.items()})
            add("fig17: replica failover serves stale reads during the cut",
                all(r["failovers"] > 0 and r["stale_reads"] > 0
                    for r in parts.values()),
                {k: (v["failovers"], v["stale_reads"]) for k, v in parts.items()})
        if degr and clean:
            add("fig17: degraded links inflate latency without downtime",
                all(r["availability"] == 1.0 for r in degr.values())
                and all(
                    degr[p]["avg_latency_ms"] > clean[p]["avg_latency_ms"]
                    for p in degr
                ),
                {k: round(v["avg_latency_ms"]) for k, v in degr.items()})
            if "geotp" in degr and "ssp" in degr:
                add("fig17: GeoTP re-plans around the degraded link (>= SSP)",
                    degr["geotp"]["throughput_tps"]
                    >= degr["ssp"]["throughput_tps"],
                    {k: round(v["throughput_tps"]) for k, v in degr.items()})

    fig18 = load("fig18_protocols")
    if fig18:
        axes = sorted({(r["level"], r["rtt_scale"]) for r in fig18})
        # TIGA rows carry a swept skew axis; the other presets run at skew 0
        fastc_ok, geotp_ok, fast_fires = [], [], []
        for level, scale in axes:
            by = rows_by(fig18, level=level, rtt_scale=scale, clock_skew_us=0)
            fastc_ok.append(by["fastc"]["wan_per_txn"] < by["ssp"]["wan_per_txn"])
            geotp_ok.append(by["geotp"]["wan_per_txn"] < by["ssp"]["wan_per_txn"])
            fast_fires.append(by["fastc"]["fast_commits"] > 0)
        add("fig18: FASTC co-coordinator commit cuts WAN rounds/txn below SSP (every cell)",
            all(fastc_ok) and fastc_ok,
            {f"{lv} x{sc}": (round(rows_by(fig18, level=lv, rtt_scale=sc, clock_skew_us=0)["fastc"]["wan_per_txn"], 2),
                             round(rows_by(fig18, level=lv, rtt_scale=sc, clock_skew_us=0)["ssp"]["wan_per_txn"], 2))
             for lv, sc in axes})
        add("fig18: decentralized prepare (GeoTP) needs fewer WAN rounds/txn than coordinated SSP",
            all(geotp_ok) and geotp_ok, f"{sum(geotp_ok)}/{len(geotp_ok)} cells")
        add("fig18: FASTC fast path fires on every cell",
            all(fast_fires) and fast_fires, f"{sum(fast_fires)}/{len(fast_fires)} cells")
        tiga_ok, tiga_detail = [], {}
        for level, scale in axes:
            series = values_over(fig18, "clock_skew_us", "fast_rate",
                                 preset="tiga", level=level, rtt_scale=scale)
            tiga_ok.append(non_increasing(series, tol=0.02) and series[-1] < series[0])
            tiga_detail[f"{level} x{scale}"] = [round(v, 2) for v in series]
        add("fig18: TIGA single-round commit rate degrades as clock skew eats the slack",
            all(tiga_ok) and tiga_ok, tiga_detail)
        hot = rows_by(fig18, level="hotspot", rtt_scale=1.0, clock_skew_us=0)
        if "opta" in hot and "ssp" in hot:
            add("fig18: OPTA trades aborts for commit latency under contention (vs lock-wait SSP)",
                hot["opta"]["abort_rate"] >= hot["ssp"]["abort_rate"]
                and hot["opta"]["avg_latency_ms"] < hot["ssp"]["avg_latency_ms"],
                dict(opta=(round(hot["opta"]["abort_rate"], 3), round(hot["opta"]["avg_latency_ms"])),
                     ssp=(round(hot["ssp"]["abort_rate"], 3), round(hot["ssp"]["avg_latency_ms"]))))

    t1 = load("table1_heterogeneous")
    if t1:
        oks = []
        for r in t1:
            if r["preset"] != "geotp":
                continue
            pair = [
                s for s in t1
                if s["preset"] == "ssp" and s["scenario"] == r["scenario"] and s["dist_ratio"] == r["dist_ratio"]
            ]
            if pair:
                oks.append(r["throughput_tps"] > pair[0]["throughput_tps"])
        add("table1: GeoTP wins on heterogeneous deployments (>=5/6 points)",
            sum(oks) >= len(oks) - 1, f"{sum(oks)}/{len(oks)}")

    return checks
