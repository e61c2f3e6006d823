"""Geo-distributed serving demo through the port: the GeoTP router (O1
one-round finalize + O2 latency-aware dispatch + O3 admission) vs an FCFS
router, serving a reduced model across three simulated regions; the
counterpart of the reference's `examples/serve_geo.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_geo [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve

# the reference example's arguments
SERVE_ARGS = ["--requests", "600", "--rate", "900", "--policy", "both"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = serve.main([*SERVE_ARGS, "--device", args.device])
    g, f = res["geotp"], res["fcfs"]
    print(
        f"\nGeoTP router: {f['avg_latency_ms']/max(g['avg_latency_ms'],1e-9):.2f}x lower avg latency, "
        f"{f['p99_latency_ms']/max(g['p99_latency_ms'],1e-9):.2f}x lower p99 than FCFS"
    )
    return res


if __name__ == "__main__":
    main()
