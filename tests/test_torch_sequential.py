"""The port's sequential lanes (`step._step`, the twelve handlers, the lock
primitives, `apply._drain_step` and its window plan) against the
reference, on the CPU.

* (a) `step._step` on mid-run reference states (carried across with
  `interop`): every leaf equal to the reference's jitted `_step` after each
  event of a window of consecutive events, on the 12 presets (the final
  states of a 0.3 s map run; then opta's lane from its next lock-wait
  timeout) and under the reference tests' crash-heavy schedule with
  replicas (each lane from its fresh state, the reference stepped alone to
  the second crash, then to the outage's first heartbeat probe: a window
  from each).
* (b) `Simulator(device="cpu").run_grid(strategy="map")`, drained and
  single-event, at `test_torch_engine`'s shapes (T = 4, 0.3 s): every final
  leaf and `rows()` equal to the reference's map lanes.
* (c) the same runs equal the port's vmap lanes on every leaf but `fused`
  (the lockstep drain's own counter).
* (d) `batch.simulate`, fresh and continued with `state=` (a map run's
  lane, to a later horizon), equals the reference's `engine.simulate` on
  every leaf and metric.

`resume(strategy="map")` is held to the reference's map resume in
`test_torch_four_mode.py` (the two files split the time).

Every comparison is exact. Reference compiles are cached per process.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.core import engine as r_engine
from repro.core.engine.step import _step as r_step_fn
from repro.core.netmodel import derive_tau_ds_us as r_derive_tau_ds_us
from repro_torch import interop
from repro_torch.core.engine import Grid, Simulator, batch, step
from repro_torch.core.engine.batch import lane_bank
from repro_torch.core.engine.state import SimConfig, tree_leaves
from repro_torch.core.protocols import PRESETS
from test_torch_engine import (
    HORIZON_S, PRESETS as ALL12, WARMUP_S, _banks, _rows_equal, assert_states_equal,
)
from test_torch_drain import _differing_leaves
import test_torch_faults as tf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEP_WINDOW = 24  # consecutive events stepped from each preset's mid-run state
CRASH_WINDOW = 24  # events stepped from the crash-heavy schedule's second crash (and probe)
HANDLER_NAMES = tuple(h.__name__ for h in step._HANDLERS)  # in handler-id order


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _port_cfg(rcfg) -> SimConfig:
    f = {k.name: getattr(rcfg, k.name) for k in dataclasses.fields(rcfg)}
    f["proto"] = PRESETS[rcfg.proto.name]
    return SimConfig(**f)


@functools.lru_cache(maxsize=None)
def _ref_map(drain):
    rbank = _banks()[0]
    sim = r_engine.Simulator.from_bank(rbank, horizon_s=HORIZON_S, warmup_s=WARMUP_S,
                                       drain=drain, track_slots=True)
    return sim.run_grid(r_engine.Grid.cross(preset=ALL12), rbank, strategy="map")


@functools.lru_cache(maxsize=None)
def _port(drain, strategy):
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=drain,
                              track_slots=True, device="cpu")
    return sim.run_grid(Grid.cross(preset=ALL12), tbank, strategy=strategy)


_r_step = jax.jit(r_step_fn, static_argnums=0)


def _lane_equal(ts, rs, what):
    """Every leaf of the one-lane port state equal to the unbatched
    reference state's (dtype included)."""
    ref = _np_tree(rs)
    for name, x in tree_leaves(ts):
        r = ref
        for part in name.split("."):
            r = getattr(r, part)
        got = x[0].numpy()
        assert got.dtype == r.dtype and np.array_equal(got, r), f"{what}: leaf {name}"


def _next_slot(rs, M0):
    """The flat index of a reference state's next event, and whether it is
    an op lock-wait (OP_WAIT) timeout."""
    parts = [rs.term_time, rs.sub_time.ravel(), rs.op_time.ravel()]
    if rs.fault_time.shape[0]:
        parts += [rs.fault_time, rs.hb_time]
    i = int(np.argmin(np.concatenate([np.asarray(x) for x in parts])))
    TK = rs.op_state.size
    return i, M0 - TK <= i < M0 and int(np.asarray(rs.op_state).ravel()[i - M0 + TK]) == 4


def _advance(rcfg, rbank, rs, until, limit=2000):
    """Step the reference alone until `until(flat index, is_wait)` holds for
    its next event."""
    M0 = rcfg.terminals * (1 + rcfg.num_ds + rcfg.max_ops)
    for _ in range(limit):
        if until(*_next_slot(rs, M0)):
            return rs
        rs = _r_step(rcfg, rbank, rs)
    raise AssertionError("no such event within the limit")


def _compare_window(cfg, tbank, rcfg, rbank, rs, n, what):
    """Carry the unbatched reference state `rs` across and step both
    packages n events, every leaf compared after each."""
    ts = interop.state_from_numpy(_np_tree(jax.tree_util.tree_map(lambda x: x[None], rs)))
    for e in range(n):
        rs = _r_step(rcfg, rbank, rs)
        ts = step._step(cfg, tbank, ts)
        _lane_equal(ts, rs, f"{what}, event {e}")
    return rs


def _lanes(rstates):
    B = int(np.asarray(rstates.now).shape[0])
    return [jax.tree_util.tree_map(lambda x: x[b], rstates) for b in range(B)]


def _port_bank(rbank):
    return lane_bank(interop.bank_from_numpy(_np_tree(rbank._asdict())), 1, False)


@pytest.fixture
def handler_log(monkeypatch):
    """The handlers `_step` called, by name (wrapping its switch table)."""
    log = []

    def wrap(h):
        def called(*a):
            log.append(h.__name__)
            return h(*a)
        return called

    monkeypatch.setattr(step, "_HANDLERS", tuple(wrap(h) for h in step._HANDLERS))
    return log


def test_step_matches_reference_on_mid_run_states(handler_log):
    """The 12 presets: each lane's final state of a 0.3 s map run is a
    state in the middle of a longer run. Then opta's lane (lock waits time
    out at once) from its next lock-wait timeout on."""
    rres = _ref_map(False)
    rbank = _banks()[0]
    cfg, tbank = _port_cfg(rres.cfg), _port_bank(rbank)
    lanes = _lanes(rres.states)
    for b, rs in enumerate(lanes):
        _compare_window(cfg, tbank, rres.cfg, rbank, rs, STEP_WINDOW, f"lane {b}")
    rs = _advance(rres.cfg, rbank, lanes[ALL12.index("opta")], lambda i, wait: wait)
    _compare_window(cfg, tbank, rres.cfg, rbank, rs, 8, "opta's timeout")
    # every event kind the fault-free engine has, but the noop valve
    assert set(handler_log) == set(HANDLER_NAMES[:step.H_NOOP]), sorted(set(handler_log))


def test_step_matches_reference_under_crash_heavy_schedule(handler_log):
    """Each lane from its fresh state, the reference stepped alone up to
    the second crash: a window across the crash, then one from the first
    heartbeat probe of the outage on."""
    rbank = tf._banks()[0]
    grid = r_engine.Grid.cross(preset=("ssp", "geotp"), rtt_ms=tf.RTT,
                               faults=(tf.CRASH_HEAVY,), **tf.REPLICAS)
    sim = r_engine.Simulator.from_bank(rbank, horizon_s=tf.HORIZON_S, warmup_s=0.0,
                                       drain=False, track_slots=True)
    rcfg = sim._cfg_for(grid.world(0).faults)
    assert rcfg.max_faults == 3
    cfg, tbank = _port_cfg(rcfg), _port_bank(rbank)
    M0 = rcfg.terminals * (1 + rcfg.num_ds + rcfg.max_ops)
    F = rcfg.max_faults
    for b in range(len(grid)):
        rs = r_engine.init_state_world(rcfg, grid.world(b))
        for what, until in (("crash", lambda i, wait: M0 + 1 == i),  # row 1: DS 1 crashes
                            ("probe", lambda i, wait: i >= M0 + F)):
            rs = _advance(rcfg, rbank, rs, until)
            rs = _compare_window(cfg, tbank, rcfg, rbank, rs, CRASH_WINDOW, f"lane {b}'s {what}")
    hit = set(handler_log)
    assert {"_h_fault", "_h_hb", "_h_start_txn", "_h_ds_finish"} <= hit, sorted(hit)
    assert "_h_noop" not in hit


@pytest.mark.parametrize("drain", [False, True], ids=["single", "drained"])
def test_map_run_grid_matches_reference_and_vmap_lanes(drain):
    tres, rres = _port(drain, "map"), _ref_map(drain)
    assert tres.strategy == tres.strategy_resolved == "map"
    assert not tres.cfg.lockstep and tres.cfg.drain == drain
    # (b) the reference's map lanes: every leaf, `fused` included (neither fuses)
    assert_states_equal(tres.states, rres.states)
    _rows_equal(tres.rows(), rres.rows())
    assert int(tres.states.fused.sum()) == 0
    # steps: the lanes' loop iterations, summed
    d = tres.drain
    assert tres.steps == d["loop_iters"] == d["seq_events"] + d["windows"]
    if drain:
        assert d["drained_events"] > 0 and tres.steps < tres.events
    else:
        assert tres.steps == tres.events
    # (c) the port's vmap lanes: every leaf but `fused`
    vres = _port(drain, "vmap")
    diff = _differing_leaves(tres.states, vres.states)
    assert list(diff) == (["fused"] if drain else []), diff
    _rows_equal(tres.rows(), vres.rows())


def test_simulate_matches_reference_fresh_and_continued():
    """One config for both calls (single-event: the drained sequential lanes
    are held to the reference above): a fresh world, and geotp's lane of
    the 0.3 s map run continued to its horizon."""
    rbank, tbank = _banks()
    rcfg = dataclasses.replace(_ref_map(False).cfg, horizon_us=450_000)
    cfg = _port_cfg(rcfg)
    assert not cfg.drain and not cfg.lockstep
    tau = np.array((0, 27_000, 73_000, 251_000), np.int32)
    tau_ds = np.array(r_derive_tau_ds_us(tau))
    scale = (1000, 1000, 2000, 1000)
    rs, rm = r_engine.simulate(rcfg, rbank, tau, tau_ds, 30, scale)
    ts, tm = batch.simulate(cfg, tbank, tau, tau_ds, 30, scale, device="cpu")
    assert ts.now.shape == (1,)
    _lane_equal(ts, rs, "fresh")
    _rows_equal([tm], [rm])
    lane = ALL12.index("geotp")
    mid = jax.tree_util.tree_map(lambda x: x[lane], _ref_map(False).states)
    rs2, rm2 = r_engine.simulate(rcfg, rbank, None, None, state=mid)
    ts2, tm2 = batch.simulate(cfg, tbank, None, None, device="cpu", state=interop.state_from_numpy(
        _np_tree(jax.tree_util.tree_map(lambda x: x[None], mid))))
    _lane_equal(ts2, rs2, "continued")
    _rows_equal([tm2], [rm2])
    assert tm2["events"] > int(mid.iters)
