"""The port's examples (`repro_torch.examples`) against the reference's
`examples/`, on the CPU.

* `simulate_paper`: the three rows (ssp / geotp-o1 / geotp-o1o2 on the
  one-transaction bank) equal the reference example's, and so does every
  printed line.
* `quickstart`: section 1 (Eq.3 offsets and lock spans) prints the
  reference's line; sections 1-2 need the card unless told ``--device
  cpu`` (section 2 runs on the card in a chip run: at 16 terminals and 6 s
  it is minutes on the CPU).
* `serve_geo`: drives `launch.serve.main` with the reference example's
  arguments (plus the device) and prints the same summary.
"""

import contextlib
import importlib.util
import io
import pathlib
import re

import pytest
import torch

from repro.core import engine as r_engine
from repro_torch.examples import quickstart, serve_geo, simulate_paper
from test_torch_engine import _rows_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_simulate_paper_rows_equal_the_reference():
    ref = _reference_example("simulate_paper")
    r_out, t_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(r_out):
        ref.main()
    with contextlib.redirect_stdout(t_out):
        rows = simulate_paper.main(["--device", "cpu"])
    assert t_out.getvalue() == r_out.getvalue()
    bank = ref.bank_one_txn()
    sim = r_engine.Simulator.from_bank(bank, horizon_s=3.0, warmup_s=0.0)
    grid = r_engine.Grid.cross(preset=("ssp", "geotp-o1", "geotp-o1o2"), rtt_ms=(10.0, 100.0),
                               jitter_milli=0)
    want = sim.run_grid(grid, bank).rows()
    assert [r["preset"] for r in rows] == ["ssp", "geotp-o1", "geotp-o1o2"]
    _rows_equal(rows, want)
    # the paper's ordering: O1 cuts the latency, O2 the lock span
    assert rows[1]["avg_latency_ms"] < rows[0]["avg_latency_ms"]
    assert rows[2]["avg_lcs_ms"] < rows[1]["avg_lcs_ms"]


class _Stop(Exception):
    pass


def test_quickstart_section_one_prints_the_reference_line(monkeypatch):
    import jax.numpy as jnp

    from repro.core import scheduler as r_sched

    tau = jnp.asarray([10_000, 100_000, 27_000], jnp.int32)
    inv = jnp.asarray([True, True, True])
    off = r_sched.stagger_offsets(tau, inv)
    lcs = r_sched.lock_contention_span(tau, inv, off)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(quickstart.Simulator, "from_bank", stop)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(_Stop):
        quickstart.main(["--device", "cpu"])
    line = out.getvalue().splitlines()[0]
    assert line.startswith("Eq.(3) dispatch offsets (µs): tensor([")
    text = line.split("(µs):", 1)[1].replace("torch.int32", "")
    nums = [int(x) for x in re.findall(r"-?\d+", text)]
    assert nums == [int(x) for x in off.tolist()] + [int(x) for x in lcs.tolist()]


@pytest.mark.parametrize("mod", [quickstart, simulate_paper])
def test_examples_need_the_card_unless_told(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"), contextlib.redirect_stdout(io.StringIO()):
        mod.main([])


def test_serve_geo_drives_serve_with_the_reference_arguments(monkeypatch):
    from repro.launch import serve as r_serve
    from repro_torch.launch import serve

    fake = {"geotp": {"avg_latency_ms": 50.0, "p99_latency_ms": 90.0},
            "fcfs": {"avg_latency_ms": 80.0, "p99_latency_ms": 300.0}}
    seen = {}
    monkeypatch.setattr(r_serve, "main", lambda argv: seen.setdefault("ref", argv) and fake)
    monkeypatch.setattr(serve, "main", lambda argv: seen.setdefault("port", argv) and fake)
    ref = _reference_example("serve_geo")
    r_out, t_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(r_out):
        ref.main()
    with contextlib.redirect_stdout(t_out):
        serve_geo.main(["--device", "cpu"])
    assert seen["port"] == seen["ref"] + ["--device", "cpu"]
    assert serve_geo.SERVE_ARGS == seen["ref"]
    assert t_out.getvalue() == r_out.getvalue()
