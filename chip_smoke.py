"""Chip smoke test: the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero):

1. environment — torch / CUDA versions and the card's name and power limit;
2. build — the `geo_schedule` CUDA kernel from `src/repro_torch/csrc`;
3. kernel vs plain version on the card — the reference kernel's GEO_CASES
   shapes plus N = 16 at D = 4, K = 5, then the two launches of one
   lockstep step built as the step builds them (Eq.9 at [16,1] + [16,5]
   with zero tau/lel and an all-False inv; Eq.8 at [16,4] + [16,1] with an
   all-False valid), with all-masked rows: offsets equal, p_abort within
   1e-6; CUDA-event times of the kernel and the plain version at those two
   launch shapes;
4. end to end, GPU vs CPU — all 12 presets (YCSB, T = 16, D = 4, paper
   RTTs, jitter 30, 1 s horizon) through `Simulator.run_grid` on both
   devices; every final `SimState` leaf must be equal;
5. the main path at full width — fig5's YCSB deployment (4 data sources at
   0/27/73/251 ms, 1M records per node, zipf 0.9, 20% distributed, 5 ops,
   256 txns per terminal, T = 128 terminals) for ssp / ssp-local /
   scalardb / geotp x seeds 0-3 with per-seed banks (B = 16 lanes); the
   horizon is cut from fig5's 10 s / 2 s warmup to 2.5 s / 0.5 s. Checks
   noops == 0 and commits > 0 on every lane, and that the kernel launched
   exactly twice per lockstep step.

The last two lines are a JSON record of the kernels and
{"ok": true, "device": {...}}. Needs one card; imports no JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PRESETS_MAIN = ("ssp", "ssp-local", "scalardb", "geotp")
SEEDS_MAIN = (0, 1, 2, 3)
T_MAIN = 128
HORIZON_S, WARMUP_S = 2.5, 0.5  # cut from fig5's 10 s / 2 s
GEO_CASES = [(64, 4, 8), (256, 8, 16), (100, 3, 5), (48, 4, 5), (37, 2, 4), (16, 4, 5)]
B_MAIN, D_MAIN, K_MAIN = 16, 4, 5  # lanes, data sources, ops per txn of phase 5
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def geo_inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    tau = rng.integers(0, 300_000, (n, d)).astype(np.int32)
    lel = rng.integers(0, 50_000, (n, d)).astype(np.int32)
    inv = rng.random((n, d)) < 0.6
    inv[:, 0] = True
    inv[-1] = False
    c = rng.integers(0, 100, (n, k)).astype(np.int32)
    t = (c + rng.integers(0, 50, (n, k))).astype(np.int32)
    a = rng.integers(0, 10, (n, k)).astype(np.int32)
    valid = rng.random((n, k)) < 0.8
    valid[-2] = False
    return [torch.from_numpy(x) for x in (tau, lel, inv, c, t, a, valid)]


def step_launches(n, d, k, seed):
    """The kernel's two launches in one lockstep step, built as the step
    builds them: Eq.9 (`omni.py`) with [n,1] zero tau/lel and an all-False
    inv beside [n,k] counts; Eq.8 (`handlers._stagger`) with [n,d] tau/lel
    beside [n,1] zero counts and an all-False valid."""
    tau, lel, inv, c, t, a, valid = geo_inputs(n, d, k, seed)
    zn = torch.zeros((n, 1), dtype=torch.int32)
    return {
        "eq9": (zn, zn, zn.bool(), c, t, a, valid),
        "eq8": (tau, lel, inv, zn, zn, zn, zn.bool()),
    }


def check_kernel(args, label, geo_schedule, geo_schedule_ref) -> float:
    """Kernel == plain version on `args`: offsets equal, |dp| <= 1e-6, and
    all-masked rows give off = 0, p = 0. Returns max |dp|."""
    off_r, p_r = geo_schedule_ref(*args)
    off, p = geo_schedule(*args)
    torch.cuda.synchronize()
    if not torch.equal(off, off_r):
        raise AssertionError(f"offsets differ at {label}")
    err = (p - p_r).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"p_abort differs by {err} at {label}")
    dead_d, dead_k = ~args[2].any(1), ~args[6].any(1)
    if off[dead_d].any() or p[dead_k].any():
        raise AssertionError(f"all-masked rows must give off = 0 and p = 0 at {label}")
    print(f"{label}: offsets equal, max |dp| = {err:.3g}")
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, timed with CUDA events."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def geo_work(tau, lel, inv, c, t, a, valid):
    """(bytes, operations) of one launch on these inputs: each input read
    once and both outputs written once, vs 3 int ops per D entry (max,
    subtract, clamp), 12 float ops per valid K entry (log and exp counted
    as one op each) and the final exp of each row."""
    n, d = tau.shape
    k = c.shape[1]
    nbytes = n * (d * (4 + 4 + 1) + k * (4 * 3 + 1) + d * 4 + 4)
    return nbytes, 3 * n * d + 12 * int(valid.sum()) + n


def bound(nbytes, ops):
    """Least time (ms) for this work on the card, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main_grid():
    """Phase 5's grid: fig5's YCSB deployment at T = 128 for the smoke
    presets x seeds 0-3, each cell with its seed's bank (16 lanes)."""
    from repro_torch.core import workloads
    from repro_torch.core.engine import Grid

    banks = {
        sd: workloads.make_ycsb_bank(
            workloads.YCSBConfig(num_ds=4, records_per_node=1_000_000, ops_per_txn=5,
                                 dist_ratio=0.2, theta=0.9, seed=sd), T_MAIN, 256)
        for sd in SEEDS_MAIN
    }
    cells = [dict(preset=p, seed=sd) for sd in SEEDS_MAIN for p in PRESETS_MAIN]
    return Grid(cells, banks=[banks[c["seed"]] for c in cells])


def leaf_mismatches(a, b):
    from repro_torch.core.engine.state import tree_leaves

    out = []
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            out.append((name, "dtype/shape"))
            continue
        neq = (x != y).reshape(x.shape[0], -1).any(1) if x.dim() else (x != y).reshape(1)
        lanes = torch.nonzero(neq).flatten().tolist()
        if lanes:
            out.append((name, lanes))
    return out


def main() -> int:
    phase("1 environment")
    print("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    from repro_torch.core import workloads
    from repro_torch.core.engine import Grid, Simulator
    from repro_torch.core.protocols import PRESETS
    from repro_torch.kernels import _build
    from repro_torch.kernels.geo_schedule import ops
    from repro_torch.kernels.geo_schedule.ref import geo_schedule_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print("device", kind, "count", torch.cuda.device_count())
    print(smi)
    dev = torch.device("cuda")

    phase("2 build")
    t0 = time.perf_counter()
    lib = _build.build("geo_schedule", verbose=True)
    _build.load("geo_schedule")
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")

    phase("3 geo_schedule kernel vs plain version on the card")
    max_err = 0.0
    for seed, (n, d, k) in enumerate(GEO_CASES):
        args = [x.to(dev) for x in geo_inputs(n, d, k, seed)]
        err = check_kernel(args, f"N={n:4d} D={d:2d} K={k:2d}", ops.geo_schedule,
                           geo_schedule_ref)
        max_err = max(max_err, err)
    # the main path's two launch shapes; their mean is the per-launch figure
    # of the kernel record, since each step launches each shape once
    kern_ms = plain_ms = 0.0
    work = np.zeros(2)
    for label, host_args in step_launches(B_MAIN, D_MAIN, K_MAIN, seed=99).items():
        args = [x.to(dev) for x in host_args]
        shape = f"{label} tau[{args[0].shape[0]},{args[0].shape[1]}] c[{args[3].shape[1]}]"
        max_err = max(max_err, check_kernel(args, shape, ops.geo_schedule, geo_schedule_ref))
        k_ms = cuda_ms(lambda: ops.geo_schedule(*args), 2000)
        p_ms = cuda_ms(lambda: geo_schedule_ref(*args), 500)
        w = geo_work(*host_args)
        b_ms, b_by = bound(*w)
        print(f"{shape}: kernel {k_ms:.5f} ms/call, plain {p_ms:.5f} ms/call, "
              f"{w[0]} bytes, {w[1]} ops, bound {b_ms:.3g} ms ({b_by})")
        kern_ms, plain_ms, work = kern_ms + k_ms / 2, plain_ms + p_ms / 2, work + np.array(w) / 2
    bound_ms, bound_by = bound(*work)
    print(f"per launch, mean of the two: kernel {kern_ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"bound {bound_ms:.3g} ms ({bound_by}); max |dp| over all cases {max_err:.3g}")

    phase("4 end to end: GPU vs CPU, all 12 presets")
    cfg_w = workloads.YCSBConfig(num_ds=4, records_per_node=1_000_000, ops_per_txn=5,
                                 dist_ratio=0.2, theta=0.9, seed=0)
    bank16 = workloads.make_ycsb_bank(cfg_w, 16, 256)
    grid12 = Grid.cross(preset=tuple(sorted(PRESETS)), jitter_milli=30)
    res = {}
    for name in ("cuda", "cpu"):
        sim = Simulator.from_bank(bank16, horizon_s=1.0, warmup_s=0.2, track_slots=True,
                                  device=name)
        res[name] = sim.run_grid(grid12, bank16)
        print(f"{name}: {res[name].steps} steps, {res[name].events} events, "
              f"{res[name].wall_s:.2f} s")
    bad = leaf_mismatches(res["cuda"].states, res["cpu"].states)
    for name, lanes in bad:
        print(f"MISMATCH leaf {name} lanes {lanes}")
    if bad:
        raise AssertionError(f"{len(bad)} SimState leaves differ between GPU and CPU")
    print(f"every SimState leaf equal on 12 lanes ({len(res['cpu'].states)} fields)")

    phase("5 main path: fig5 YCSB, T=128, 16 lanes")
    print(f"CUT: horizon {HORIZON_S} s / warmup {WARMUP_S} s (fig5: 10 s / 2 s)")
    t0 = time.perf_counter()
    grid = main_grid()
    cells = grid.cells
    print(f"banks built in {time.perf_counter() - t0:.2f} s")
    sim = Simulator.from_bank(grid.banks[0], horizon_s=HORIZON_S, warmup_s=WARMUP_S)
    torch.cuda.reset_peak_memory_stats()
    ops.geo_schedule.launches = 0
    main = sim.run_grid(grid)
    launches = ops.geo_schedule.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if launches != 2 * main.steps:
        raise AssertionError(f"geo_schedule launches {launches} != 2 x {main.steps} steps")
    for i, m in enumerate(main.metrics):
        if m["noops"] != 0 or m["commits"] <= 0:
            raise AssertionError(f"lane {i} {cells[i]}: noops={m['noops']} commits={m['commits']}")
    ev = main.events
    print(f"steps {main.steps} (up to 31 idle tail steps included), events {ev}, "
          f"wall {main.wall_s:.3f} s, {main.steps / main.wall_s:.1f} steps/s, "
          f"{ev / main.wall_s:.1f} events/s, peak device memory {peak_mib:.1f} MiB, "
          f"geo_schedule launches {launches}")
    for p in PRESETS_MAIN:
        rows = [r for r in main.rows() if r["preset"] == p]
        tps = np.mean([r["throughput_tps"] for r in rows])
        lat = np.mean([r["avg_latency_ms"] for r in rows])
        print(f"{p:10s} throughput {tps:9.2f} tps  avg latency {lat:8.2f} ms  "
              f"(mean of {len(rows)} seeds)")

    print(json.dumps({"kernels": [{
        "name": "geo_schedule",
        "route": "cuda",
        "source": "src/repro_torch/csrc/geo_schedule.cu",
        "replaces": "src/repro/kernels/geo_schedule/geo_schedule.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
