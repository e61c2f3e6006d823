"""Quickstart through the port: the latency-aware scheduling math, the
discrete-event engine and the model substrate, the counterpart of the
reference's `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Section 3 is one training forward pass (`stack.forward_train`) of reduced
mixtral-8x7b from the reference's initial weights for seed 0; its tokens
come from a torch generator (seed 1), not from `jax.random.randint`.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import engine, scheduler, workloads
from repro_torch.core.engine import KIND_DEGRADE, KIND_PARTITION, MW, Grid, Simulator


def model_section(device=None) -> torch.Tensor:
    """Section 3, the model substrate: one forward pass of an assigned arch."""
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.models import stack
    from repro_torch.models.schema import init_params_threefry

    dev = resolve_device(device)
    cfg = registry.reduced("mixtral-8x7b")  # tiny same-family config
    params = init_params_threefry(stack.build_schema(cfg), 0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=dev)
    logits = stack.forward_train(cfg, params, {"tokens": tokens})
    print("mixtral-8x7b (reduced) logits:", tuple(logits.shape))
    return logits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; the default is the card")
    args = ap.parse_args(argv)

    # ---- 1. The paper's core: latency-aware scheduling math ----------------
    tau = torch.tensor([10_000, 100_000, 27_000], dtype=torch.int32)  # DM->DS RTTs (µs)
    involved = torch.tensor([True, True, True])
    offsets = scheduler.stagger_offsets(tau, involved)  # Eq.(3)
    lcs = scheduler.lock_contention_span(tau, involved, offsets)
    print("Eq.(3) dispatch offsets (µs):", offsets, "-> lock spans:", lcs)

    # ---- 2. The discrete-event engine: GeoTP vs 2PC on YCSB ----------------
    # A Simulator fixed to the static shapes runs a declarative Grid of
    # presets as one batched run (lockstep lanes, captured on the card).
    bank = workloads.make_ycsb_bank(
        workloads.YCSBConfig(records_per_node=100_000, theta=0.9, dist_ratio=0.3),
        terminals=16,
        txns_per_terminal=128,
    )
    sim = Simulator.from_bank(bank, horizon_s=6.0, warmup_s=1.0, device=args.device)
    grid = Grid.cross(preset=("ssp", "geotp"), jitter_milli=0)
    res = sim.run_grid(grid, bank)  # default RTTs: Beijing/Shanghai/Singapore/London
    for row in res.rows():
        print(f"{row['preset']:6s}: {row['throughput_tps']:6.1f} txn/s, "
              f"avg {row['avg_latency_ms']:6.1f} ms, lock span {row['avg_lcs_ms']:6.1f} ms")

    # Deterministic fault injection: the `faults` Grid axis crashes data
    # sources on a fixed (t_crash_us, ds, t_recover_us) schedule; in-flight
    # work aborts through the peer-abort path, recovery re-admits the DS,
    # and availability / abort-cause telemetry lands next to the drain stats.
    faulted = Grid.cross(
        preset=("ssp", "geotp"), jitter_milli=0,
        faults=((2_000_000, 0, 4_000_000),),  # DS 0 down from t=2s to t=4s
    )
    res_f = sim.run_grid(faulted, bank)
    d = res_f.drain
    print(f"with a 2s outage of DS 0: availability {d['availability']:.4f}, "
          f"crash aborts {d['abort_causes']['crash']}, "
          f"commits during outage {d['commits_during_fault']}")
    assert 0.0 < d["availability"] < 1.0

    # Link-level faults: typed (t_start, kind, endpoint_a, endpoint_b, t_end,
    # severity) rows. A PARTITION severs one link (in-flight statements
    # defer to the heal; with `replica_tau` set, read-only work at the cut DS
    # fails over to its replica); a DEGRADE multiplies a link's RTT.
    partitioned = Grid.cross(
        preset=("ssp", "geotp"), jitter_milli=0,
        faults=(
            (2_000_000, KIND_PARTITION, MW, 0, 4_000_000, 0),   # DM<->DS0 cut
            (2_500_000, KIND_DEGRADE, MW, 1, 4_500_000, 5_000),  # DS1 5x slower
        ),
        replica_tau=(30_000,) * 4, repl_lag_us=500_000,
    )
    res_p = sim.run_grid(partitioned, bank)
    d = res_p.drain
    print(f"with a 2s partition of DS 0: availability {d['availability']:.4f}, "
          f"failovers {d['failovers']}, stale reads {d['stale_reads']} "
          f"(max staleness {d['max_staleness_us']}us), per-link downtime "
          f"{d['link_downtime_us']}us")
    assert 0.0 < d["availability"] < 1.0

    # The protocol zoo: related-work commit paths are presets too.
    # `wan_rounds` counts cross-WAN legs / 2, `fast_commits` the commit
    # decisions that landed locally; `clock_skew_us` past Tiga's 150 ms
    # slack kills its single-round fast path.
    zoo = Grid(
        [
            dict(preset="ssp", jitter_milli=0),
            dict(preset="fastc", jitter_milli=0),
            dict(preset="tiga", jitter_milli=0, clock_skew_us=0),
            dict(preset="tiga", jitter_milli=0, clock_skew_us=300_000),
            dict(preset="opta", jitter_milli=0),
        ]
    )
    res_z = sim.run_grid(zoo, bank)
    for i, row in enumerate(res_z.rows()):
        dz = engine.drain_stats(res_z.world(i), horizon_us=res_z.cfg.horizon_us)
        done = max(row["commits"] + row["aborts"], 1)
        skew = zoo.cells[i].get("clock_skew_us", 0)
        print(f"{row['preset']:6s} skew={skew // 1000:3d}ms: "
              f"{dz['wan_rounds'] / done:5.2f} WAN rounds/txn, "
              f"{dz['fast_commits']} fast commits")

    logits = model_section(args.device)
    return dict(offsets=offsets, lcs=lcs, grid=res, faults=res_f, partitions=res_p, zoo=res_z,
                logits=logits)


if __name__ == "__main__":
    main()
