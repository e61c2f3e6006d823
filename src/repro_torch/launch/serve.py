"""Serving launcher: GeoTP geo-serving engine vs FCFS baseline (port of
`repro.launch.serve`: the same options and output, plus `--device`).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 400 --policy both
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 40

Runs the arch's reduced config, as the reference launcher does; the engine
and the model's decode steps run on `--device` (default: the card).
`--arch` takes every registry config (`repro_torch.configs.registry`):
internvl2-26b and seamless-m4t-large-v2 among them, the encoder-decoder
decoding against its pods' empty encoder memory as the reference's does.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", help="a registry config's name")
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=400.0)
    ap.add_argument("--policy", default="both", choices=["geotp", "fcfs", "both"])
    ap.add_argument("--no-model", action="store_true", help="skip real decode steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import registry
    from repro_torch.serving.engine import GeoServingEngine, PodConfig, synthetic_workload

    torch.backends.cuda.matmul.allow_tf32 = False  # the default; float32 products stay float32
    cfg = registry.reduced(args.arch)
    pods = [
        PodConfig(rtt_us=0, n_slots=12),
        PodConfig(rtt_us=30_000, n_slots=12),
        PodConfig(rtt_us=100_000, n_slots=12),
    ]
    policies = ["geotp", "fcfs"] if args.policy == "both" else [args.policy]
    results = {}
    for pol in policies:
        eng = GeoServingEngine(
            cfg, pods, policy=pol, run_model=not args.no_model, device=args.device
        )
        for r in synthetic_workload(args.requests, len(pods), rate_per_s=args.rate):
            eng.submit(r)
        res = eng.run(until_us=120_000_000)
        results[pol] = res
        print(
            f"[{pol:5s}] completed={res['completed']:4d} rejected={res['rejected']:3d} "
            f"avg={res['avg_latency_ms']:.1f}ms p99={res['p99_latency_ms']:.1f}ms "
            f"slot-occupancy={res['avg_slot_occupancy_ms']:.1f}ms"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
