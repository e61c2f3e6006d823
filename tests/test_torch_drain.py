"""The port's windowed drain (`fused._omni_window`, the default `drain=True`
step) against the reference, on the CPU.

* The drained `Simulator.run_grid(device="cpu")` against the reference's
  `Simulator(drain=True, track_slots=True).run_grid(strategy="map")` (its
  sequential `_drain_step` lanes, the faster compile) on every case of
  `test_torch_engine.CASES`: every final `SimState` leaf bitwise equal but
  `fused`, the lockstep path's own counter (the map lanes never fuse), and
  the `RunResult.rows()` dicts equal.
* One 12-cell case against the reference's `strategy="vmap"`, the same
  `_omni_window` the port runs: every leaf equal, `fused` included.
* The drained run against the port's own `drain=False` run: equal on every
  leaf but the five telemetry leaves, with the reference's `drain_stats`
  invariants.
* `_window_plan` itself on mid-run states carried across with `interop`:
  every `_PlanVals` field equal to the reference's lockstep plan.

Three reference compiles (the map lanes, the vmap lanes and the plan), each
a few seconds to ~15 s on one CPU core.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.core.engine.window import _window_plan as r_window_plan
from repro_torch import interop
from repro_torch.core.engine import Grid, Simulator
from repro_torch.core.engine.batch import lane_bank
from repro_torch.core.engine.state import (
    SimConfig, _ds_send, _mw_link, _mw_send, tree_leaves,
)
from repro_torch.core.engine.window import _window_plan
from repro_torch.core.protocols import PRESETS
from test_torch_engine import CASES, HORIZON_S, WARMUP_S, _banks, _rows_equal
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TELEMETRY = ("drained", "windows", "win_stops", "fused", "chained")


def _grids(case):
    axes, theta = CASES[case]
    make = (lambda G: G.zipped(**axes)) if case == "tiga_skew" else (lambda G: G.cross(**axes))
    rbank, tbank = _banks(theta)
    return make(r_engine.Grid), make(Grid), rbank, tbank


def _port_run(case, drain=True):
    _, tg, _, tbank = _grids(case)
    sim = Simulator.from_bank(tbank, horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=drain,
                              track_slots=True, device="cpu")
    return sim.run_grid(tg, tbank, strategy="vmap")


@functools.lru_cache(maxsize=None)
def _ref_run(case, strategy="map"):
    rg, _, rbank, _ = _grids(case)
    sim = r_engine.Simulator.from_bank(rbank, horizon_s=HORIZON_S, warmup_s=WARMUP_S,
                                       drain=True, track_slots=True)
    return sim.run_grid(rg, rbank, strategy=strategy)


@functools.lru_cache(maxsize=None)
def _port_drained(case):
    return _port_run(case)


def _differing_leaves(port_states, ref_states):
    """{leaf name: differing lanes} over every leaf (dtype and shape must
    match)."""
    ref = jax.tree_util.tree_map(np.asarray, ref_states)
    out = {}
    for name, x in tree_leaves(port_states):
        r = ref
        for part in name.split("."):
            r = getattr(r, part)
        got = x.numpy()
        assert got.dtype == r.dtype and got.shape == r.shape, (name, got.dtype, r.dtype)
        lanes = [b for b in range(got.shape[0]) if not np.array_equal(got[b], r[b])]
        if lanes:
            out[name] = lanes
    return out


def _check_drain_stats(res):
    """The reference's telemetry invariants (tests/core/test_differential.py)."""
    st = res.drain
    assert sum(st["window_stops"].values()) == st["windows"], st
    assert 0 <= st["chained"] <= st["drained_events"], st
    assert st["drained_events"] + st["seq_events"] == st["events"] == res.events, st
    assert st["loop_iters"] == st["seq_events"] + st["windows"], st
    assert st["drained_events"] > 0 and st["plan_fused"], st
    return st


@pytest.mark.parametrize("case", sorted(CASES))
def test_drained_run_grid_matches_reference_map_lanes(case):
    tres, rres = _port_drained(case), _ref_run(case)
    assert len(tres) == 12 and tres.cfg.drain
    diff = _differing_leaves(tres.states, rres.states)
    assert list(diff) == ["fused"], diff  # the map lanes never fuse
    _rows_equal(tres.rows(), rres.rows())
    st = _check_drain_stats(tres)
    ref = rres.drain
    for key in ("events", "drained_events", "windows", "window_stops", "chained"):
        assert st[key] == ref[key], (key, st[key], ref[key])
    # a lockstep step is a loop iteration of every lane at once
    assert tres.steps >= int(np.max(tres.states.windows.numpy()
                                    + tres.states.iters.numpy() - tres.states.drained.numpy()))


def test_drained_run_grid_matches_reference_vmap_lanes():
    """The reference's lockstep strategy runs the same `_omni_window`: every
    leaf equal, the fused counter included."""
    tres = _port_drained("presets")
    assert _differing_leaves(tres.states, _ref_run("presets", "vmap").states) == {}
    assert int(tres.states.fused.sum()) == tres.drain["loop_iters"]


def test_drained_run_equals_the_single_event_run():
    drained, single = _port_drained("presets"), _port_run("presets", drain=False)
    assert not single.cfg.drain
    for (name, x), (_, y) in zip(tree_leaves(drained.states), tree_leaves(single.states)):
        if name not in TELEMETRY:
            assert x.dtype == y.dtype and bool((x == y).all()), name
    for name in TELEMETRY:
        assert int(getattr(single.states, name).sum()) == 0, name
    _rows_equal(drained.rows(), single.rows())
    st = _check_drain_stats(drained)
    assert st["events"] == single.events
    # fewer lockstep steps than the single-event run
    assert drained.steps < single.steps


def test_link_helpers_on_a_fault_free_state():
    """`_mw_send` / `_ds_send` reduce to `_mw_link`'s (t0, tau_true[d]) and
    (t0, tau_ds[a, b]) on the port's fault-free states."""
    s = _port_drained("tiga_skew").states
    B, D = s.tau_true.shape
    gen = torch.Generator().manual_seed(1)
    d = torch.randint(0, D, (B, 3), generator=gen)
    a = torch.randint(0, D, (B,), generator=gen)
    t0 = torch.randint(0, 10**6, (B, 3), generator=gen, dtype=torch.int32)
    on_r = torch.zeros((B, 3), dtype=torch.bool)
    link = _mw_link(s, on_r, d, t0)
    for x, y in zip(_mw_send(s, on_r, d, t0), link):
        assert torch.equal(x, y)
    assert torch.equal(link[1], s.tau_true.gather(1, d))
    base, tau = _ds_send(s, a, d, t0)
    assert torch.equal(base, t0) and torch.equal(tau, s.tau_ds[torch.arange(B)[:, None], a[:, None], d])


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@functools.partial(jax.jit, static_argnums=0)
def _ref_plan(cfg, bank, states):
    return jax.vmap(lambda s: r_window_plan(cfg, bank, s))(states)


@pytest.mark.parametrize("case", ["presets", "zero_rtt_ties"])
def test_window_plan_matches_reference_on_mid_run_states(case):
    """Each lane's final state of a 0.3 s run is a state in the middle of a
    1 s run: its plan under that horizon has windows in flight. Every
    `_PlanVals` field equal to the reference's lockstep plan (index fields
    are int64 in the port)."""
    rres = _ref_run(case)
    rbank = _grids(case)[2]
    rcfg = dataclasses.replace(rres.cfg, lockstep=True, horizon_us=1_000_000)
    ref = _np_tree(_ref_plan(rcfg, rbank, rres.states))
    f = {k.name: getattr(rcfg, k.name) for k in dataclasses.fields(rcfg)}
    f["proto"] = PRESETS[rcfg.proto.name]
    cfg = SimConfig(**f)
    states = interop.state_from_numpy(_np_tree(rres.states))
    bank = lane_bank(interop.bank_from_numpy(_np_tree(rbank._asdict())), 12, False)
    plan = _window_plan(cfg, bank, states)
    assert plan._fields == ref._fields
    for name, got, want in zip(plan._fields, plan, ref):
        got = got.numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert got.dtype == want.dtype or (got.dtype == np.int64 and want.dtype == np.int32), (
            name, got.dtype, want.dtype)
        lanes = [b for b in range(12) if not np.array_equal(got[b], want[b])]
        assert not lanes, f"{name} differs in lanes {lanes}"
    assert ref.use.any() and ref.n_chained.sum() > 0  # windows and chains formed
