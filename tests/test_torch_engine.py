"""End to end: the port's single-event lockstep step, `Simulator(drain=
False).run_grid(device="cpu")` (the drained default has its own file,
`test_torch_drain.py`), against the reference `Simulator(drain=False,
track_slots=True).run_grid(strategy="map")` — the reference's sequential
`_step` lanes, bitwise-identical to its lockstep strategy and the faster
compile on the CPU.

Every final `SimState` leaf must be equal (bitwise, dtype included) and so
must the `RunResult.rows()` dicts. Two reference compiles for the whole
file: every shared-bank grid has one shape (12 cells; presets, RTTs and
seeds are not in the jit key), the per-cell-bank grid the other.
"""

import math

import jax
import numpy as np
import pytest

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro.core.protocols import PRESETS as R_PRESETS
from repro_torch.core import workloads as t_wl
from repro_torch.core.engine import Grid, Simulator
from repro_torch.core.engine.state import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, K, D, N = 4, 5, 4, 16
HORIZON_S, WARMUP_S = 0.3, 0.05
PRESETS = tuple(sorted(R_PRESETS))  # all 12


def _banks(theta=0.9, seed=0):
    kw = dict(num_ds=D, records_per_node=2000, ops_per_txn=K, dist_ratio=0.5,
              theta=theta, seed=seed)
    return (r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), T, N),
            t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), T, N))


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            x, y = ra[k], rb[k]
            if isinstance(x, float) and math.isnan(x):
                assert isinstance(y, float) and math.isnan(y), k
            else:
                assert x == y, (ra.get("preset"), k, x, y)


def assert_states_equal(port_states, ref_states):
    """Every leaf equal; a mismatch names the leaf and the lanes."""
    ref = jax.tree_util.tree_map(np.asarray, ref_states)
    for name, x in tree_leaves(port_states):
        r = ref
        for part in name.split("."):
            r = getattr(r, part)
        got = x.numpy()
        assert got.dtype == r.dtype, (name, got.dtype, r.dtype)
        assert got.shape == r.shape, (name, got.shape, r.shape)
        if not np.array_equal(got, r):
            lanes = [b for b in range(got.shape[0]) if not np.array_equal(got[b], r[b])]
            pytest.fail(f"leaf {name} differs in lanes {lanes}")


def _run_both(rgrid, tgrid, rbank, tbank):
    rsim = r_engine.Simulator.from_bank(
        rbank if rbank is not None else rgrid.banks[0],
        horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=False, track_slots=True,
    )
    rres = rsim.run_grid(rgrid, rbank, strategy="map")
    tsim = Simulator.from_bank(
        tbank if tbank is not None else tgrid.banks[0],
        horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=False, track_slots=True, device="cpu",
    )
    tres = tsim.run_grid(tgrid, tbank, strategy="vmap")
    assert_states_equal(tres.states, rres.states)
    _rows_equal(tres.rows(), rres.rows())
    assert tres.steps >= max(m["events"] for m in tres.metrics)
    return tres


CASES = {
    # all 12 presets, paper RTTs, default jitter (30)
    "presets": (dict(preset=PRESETS), 0.9),
    # abort-heavy contention
    "theta1.6": (dict(preset=PRESETS), 1.6),
    # zero-RTT ties: event times collide and first-occurrence picks decide
    # (statements slowed 50x so the zero-latency lanes stay a few hundred
    # events long)
    "zero_rtt_ties": (dict(preset=PRESETS, rtt_ms=(0.0, 0.0, 0.0, 0.0), jitter_milli=0,
                           exec_scale_milli=(50_000,) * 4), 0.9),
    # tiga's synchronized-clock fast path under 300 ms skew (12 cells)
    "tiga_skew": (dict(preset=("tiga",) * 6 + ("geotp",) * 6,
                       clock_skew_us=300_000), 1.2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_grid_matches_reference(case):
    axes, theta = CASES[case]
    rbank, tbank = _banks(theta)
    if case == "tiga_skew":
        rg = r_engine.Grid.zipped(**axes)
        tg = Grid.zipped(**axes)
    else:
        rg = r_engine.Grid.cross(**axes)
        tg = Grid.cross(**axes)
    assert len(tg) == 12
    tres = _run_both(rg, tg, rbank, tbank)
    assert sum(m["commits"] for m in tres.metrics) > 0
    if case == "tiga_skew":
        assert tres.rows()[0]["clock_skew_us"] == 300_000


def test_run_grid_per_cell_banks_matches_reference():
    seeds = (0, 1, 2)
    presets = ("ssp", "ssp-local", "scalardb", "geotp")
    pairs = {sd: _banks(0.9, seed=sd) for sd in seeds}
    cells = [dict(preset=p, seed=sd) for sd in seeds for p in presets]
    rg = r_engine.Grid(cells, banks=[pairs[c["seed"]][0] for c in cells])
    tg = Grid(cells, banks=[pairs[c["seed"]][1] for c in cells])
    tres = _run_both(rg, tg, None, None)
    assert tres.bank_batched
    assert all(m["noops"] == 0 for m in tres.metrics)
