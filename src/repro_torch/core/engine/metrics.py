"""Host-side metric extraction: summaries, drain telemetry, CDFs (port of
`repro.core.engine.metrics`; numpy on the host, same dict keys and values)."""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine.state import (
    ABORT_CAUSES,
    HIST_BINS,
    STOP_REASONS,
    _HIST_BASE_US,
    SimConfig,
    SimState,
    tree_map,
)


def to_host(states: SimState) -> SimState:
    """Every leaf as a numpy array (one device-to-host copy each)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), states)


def world_index(states: SimState, i: int) -> SimState:
    """Slice world i out of a batched final state."""
    return tree_map(lambda x: x[i], states)


def summarize_batch(cfg: SimConfig, states: SimState) -> list:
    host = to_host(states)
    B = int(host.now.shape[0])
    return [summarize(cfg, world_index(host, i)) for i in range(B)]


def summarize(cfg: SimConfig, s) -> dict:
    """One world's metrics (leaves may be tensors or numpy arrays)."""
    s = tree_map(np.asarray, s)
    span_s = max((cfg.horizon_us - cfg.warmup_us) / 1e6, 1e-9)
    commits = int(s.commits)
    aborts = int(s.aborts)
    lat_p = _percentiles(np.asarray(s.hist_all), (0.5, 0.99, 0.999))
    cen = _percentiles(np.asarray(s.hist_cen), (0.5, 0.99))
    dst = _percentiles(np.asarray(s.hist_dist), (0.5, 0.99))
    return {
        "throughput_tps": commits / span_s,
        "commits": commits,
        "aborts": aborts,
        "abort_rate": aborts / max(commits + aborts, 1),
        "avg_latency_ms": int(s.lat_sum) / max(commits, 1),
        "avg_latency_dist_ms": int(s.lat_sum_dist) / max(int(s.commits_dist), 1),
        "p50_ms": lat_p[0],
        "p99_ms": lat_p[1],
        "p999_ms": lat_p[2],
        "p50_centralized_ms": cen[0],
        "p99_centralized_ms": cen[1],
        "p50_distributed_ms": dst[0],
        "p99_distributed_ms": dst[1],
        "avg_lcs_ms": int(s.lcs_sum) / max(int(s.lcs_cnt), 1),
        "noops": int(s.noops),
        "events": int(s.iters),
        "sim_end_s": float(s.now) / 1e6,
    }


def drain_stats(state, horizon_us: int | None = None) -> dict:
    """Windowed-drain + fault telemetry for a final state (single or
    batched); the reference's keys. The drain counters are 0 after a
    `drain=False` run; on the port's fault-free path availability is 1.0."""
    state = tree_map(lambda x: np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x), state)
    events = int(np.sum(state.iters))
    drained = int(np.sum(state.drained))
    windows = int(np.sum(state.windows))
    stops = np.asarray(state.win_stops).reshape(-1, len(STOP_REASONS)).sum(axis=0)
    causes = np.asarray(state.ab_cause).reshape(-1, len(ABORT_CAUSES)).sum(axis=0)
    down_us = np.asarray(state.down_us, dtype=np.int64)
    ds_down = np.asarray(state.ds_down)
    down_since = np.asarray(state.down_since, dtype=np.int64)
    if horizon_us is None:
        end = np.asarray(state.now, dtype=np.int64)[..., None]
    else:
        end = np.int64(horizon_us)
    mw_heal = np.asarray(state.mw_heal, dtype=np.int64)
    still_cut = ds_down | (mw_heal > end)
    total_down = down_us + np.where(still_cut, np.maximum(end - down_since, 0), 0)
    wall = np.broadcast_to(end, total_down.shape)
    avail = 1.0 - float(total_down.sum()) / max(float(wall.sum()), 1.0)
    link_down = total_down.reshape(-1, total_down.shape[-1]).sum(axis=0)
    return {
        "events": events,
        "drained_events": drained,
        "seq_events": events - drained,
        "drain_hit_rate": round(drained / max(events, 1), 4),
        "windows": windows,
        "mean_window_len": round(drained / max(windows, 1), 2),
        "loop_iters": (events - drained) + windows,
        "window_stops": {r: int(c) for r, c in zip(STOP_REASONS, stops)},
        "chained": int(np.sum(state.chained)),
        "plan_fused": bool(np.sum(state.fused) > 0),
        "availability": round(avail, 6),
        "abort_causes": {r: int(c) for r, c in zip(ABORT_CAUSES, causes)},
        "commits_during_fault": int(np.sum(state.commits_fault)),
        "link_downtime_us": [int(x) for x in link_down],
        "stale_reads": int(np.sum(state.stale_reads)),
        "failovers": int(np.sum(state.failovers)),
        "max_staleness_us": int(np.max(state.max_stale_us)),
        "wan_rounds": int(np.sum(state.wan_legs)) / 2.0,
        "fast_commits": int(np.sum(state.fast_commits)),
    }


def _percentiles(hist: np.ndarray, qs) -> list:
    total = hist.sum()
    if total == 0:
        return [float("nan")] * len(qs)
    cum = np.cumsum(hist)
    out = []
    for q in qs:
        b = min(int(np.searchsorted(cum, q * total)), HIST_BINS - 1)
        out.append(_HIST_BASE_US * (2.0 ** ((b + 0.5) / 8.0)) / 1000.0)  # ms
    return out


def latency_cdf(hist: np.ndarray):
    """Returns (latency_ms[bins], cdf[bins]) for CDF plots (Fig 8)."""
    edges = _HIST_BASE_US * (2.0 ** ((np.arange(HIST_BINS) + 1) / 8.0)) / 1000.0
    total = max(hist.sum(), 1)
    return edges, np.cumsum(hist) / total
