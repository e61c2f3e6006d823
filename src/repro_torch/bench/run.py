"""The paper's figures and claims through the port:
``python -m repro_torch.bench.run [--full] [--only figX] [--validate-only]
[--smoke] [--device cpu]``.

The counterpart of the reference's ``python -m benchmarks.run``. It runs
every function of `figures.ALL_FIGURES` (``--only``: one name, or the names
that start with it followed by ``_``) at the quick widths (``--full``: the
paper sizes), each figure's payload under ``results/bench_torch/`` and each
sweep in the port's bench file, then prints the claim summary
(`claims.validate`). A figure that fails prints ``[FAILED]`` and the run
goes on. After each figure it prints its wall seconds, sweeps, lanes,
steps, events and events/s.

It runs on the card; ``--device cpu`` asks for the CPU. Without a card
and without ``--device cpu`` it raises before anything runs. ``--smoke``
runs the port's smoke (`repro_torch.bench.smoke.main`); ``--strategy
mesh`` raises: the mesh placement is not ported (A7).
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.bench import claims
from repro_torch.device import resolve_device
from repro_torch.unported import not_ported


def selected(only: str | None) -> list:
    """The figure functions `--only` picks, in `ALL_FIGURES`' order."""
    from repro_torch.bench import figures

    return [fn for fn in figures.ALL_FIGURES
            if not only or fn.__name__ == only or fn.__name__.startswith(only + "_")]


def figure_line(rec: dict) -> str:
    return (f"===== {rec['name']} done in {rec['wall_s']:.1f}s: {rec['sweeps']} sweeps, "
            f"{rec['lanes']} lanes, {rec['steps']} steps, {rec['events']} events, "
            f"{rec['events'] / max(rec['wall_s'], 1e-9):.1f} events/s =====")


def run_figures(fns, quick: bool, device=None) -> list:
    """Run each figure function, going on past a failure; returns one
    record a figure (`figures.timed`'s, or ``failed`` with the error)."""
    import traceback

    from repro_torch.bench import figures

    out = []
    for fn in fns:
        print(f"\n===== {fn.__name__} =====", flush=True)
        opts = figures.Options(device=device)
        t0 = time.perf_counter()
        try:
            rec = figures.timed(fn, quick, opts)
        except Exception as e:  # keep the suite going; failures show below
            print(f"[FAILED] {fn.__name__}: {e}")
            traceback.print_exc()
            out.append(dict(name=fn.__name__, failed=repr(e), wall_s=time.perf_counter() - t0))
            print(f"===== {fn.__name__} failed after {time.perf_counter() - t0:.0f}s =====",
                  flush=True)
            continue
        out.append(rec)
        print(figure_line(rec), flush=True)
    return out


def print_claims() -> list:
    print("\n================ PAPER-CLAIM VALIDATION ================")
    checks = claims.validate()
    n_ok = 0
    for name, ok, detail in checks:
        n_ok += ok
        print(f"[{'PASS' if ok else 'FAIL'}] {name} :: {detail}")
    print(f"{n_ok}/{len(checks)} claims validated")
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="paper-size sweeps")
    ap.add_argument("--only", default=None, help="run a single figure, e.g. fig12")
    ap.add_argument("--validate-only", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the port's smoke (repro_torch.bench.smoke)")
    ap.add_argument("--strategy", default=None, choices=("mesh",),
                    help="with --smoke in the reference: a forced placement; the port's "
                         "mesh placement is not ported (A7)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the default is the card")
    args = ap.parse_args(argv)

    if args.strategy == "mesh":
        raise not_ported('--strategy mesh (multi-GPU grids)', "A7")
    device = resolve_device(args.device)  # raises without a card unless told "cpu"
    if args.smoke:
        from repro_torch.bench import smoke

        return smoke.main(["--device", device.type])

    if not args.validate_only:
        run_figures(selected(args.only), not args.full, device=device)
    print_claims()
    return 0


if __name__ == "__main__":
    sys.exit(main())
