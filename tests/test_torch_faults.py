"""The port's fault injection (typed crash / partition / degrade schedules,
heartbeats, replica failover) against the reference, on the CPU.

* (a) `CRASH_HEAVY`, `PART_HEAVY` and `DEGRADE_HEAVY` (the reference tests'
  schedules, replicas at 60 ms with a 250 ms lag) as one 6-lane grid
  through the port's `run_grid(device="cpu")`, drained and single-event
  (the drained case in `test_torch_faults_drained.py`, so that pytest-xdist
  can run it beside the rest):
  every final `SimState` leaf bitwise the reference's `strategy="vmap"`
  lanes, every leaf but `fused` its `strategy="map"` lanes, and the
  `drain_stats` equal.
* (b) an all-pad (INF_US) schedule against the fault-free run, all 12
  presets: every leaf equal but the schedule's own leaves
  (`test_torch_faults_pad.py`).
* (c) `_fault_event` / `_hb_event` on mid-run states carried across with
  `interop`, one case per kind and stage, against `jax.vmap` of the
  reference's, field by field.
* (d) `_window_plan` on a faulted mid-run state (a due fault row, armed
  probes that fire and that do not): every `_PlanVals` field against the
  reference's lockstep plan.
* (e) the Grid's schedule validation: the reference's exception type and
  message, cell index included; `max_faults` derived from the grid.

Every comparison is exact (no float tolerance anywhere). Reference
compiles are cached per process (`functools.lru_cache`).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro.core.engine.faults import _fault_event as r_fault_event
from repro.core.engine.faults import _hb_event as r_hb_event
from repro.core.engine.window import _window_plan as r_window_plan
from repro_torch import interop
from repro_torch.core import workloads as t_wl
from repro_torch.core.engine import Grid, Simulator
from repro_torch.core.engine.batch import lane_bank
from repro_torch.core.engine.chain import STOP_FAULT
from repro_torch.core.engine.faults import _fault_event, _hb_event
from repro_torch.core.engine.state import (
    INF_US, KIND_CRASH, KIND_DEGRADE, KIND_PARTITION, MW, SimConfig, tree_leaves,
)
from repro_torch.core.engine.window import _window_plan
from repro_torch.core.protocols import PRESETS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, K, D, N = 8, 4, 2, 32
RTT = (10.0, 100.0)
HORIZON_S = 2.0
REPLICAS = dict(replica_tau=(60_000, 60_000), repl_lag_us=250_000)

# tests/core/test_faults.py and tests/core/test_partitions.py
CRASH_HEAVY = (
    (100_000, 0, 400_000),
    (600_000, 1, 1_300_000),
    (1_500_000, 0, 1_700_000),
)
PART_HEAVY = (
    (200_000, KIND_PARTITION, MW, 0, 1_200_000, 0),
    (1_300_000, KIND_DEGRADE, MW, 1, 1_800_000, 5_000),
    (1_400_000, KIND_PARTITION, 0, 1, 1_900_000, 0),
)
DEGRADE_HEAVY = (
    (100_000, KIND_DEGRADE, MW, 0, 900_000, 8_000),
    (300_000, KIND_DEGRADE, 0, 1, 1_200_000, 4_000),
    (1_000_000, KIND_DEGRADE, MW, 1, 1_900_000, 6_000),
)
SCHEDULES = (CRASH_HEAVY, PART_HEAVY, DEGRADE_HEAVY)
AXES = dict(preset=("ssp", "geotp"), rtt_ms=RTT, faults=SCHEDULES, **REPLICAS)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _banks():
    kw = dict(num_ds=D, records_per_node=2000, ops_per_txn=K, dist_ratio=0.5, theta=0.9, seed=0)
    return (r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), T, N),
            t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), T, N))


@functools.lru_cache(maxsize=None)
def _ref_run(drain, strategy):
    rbank = _banks()[0]
    sim = r_engine.Simulator.from_bank(rbank, horizon_s=HORIZON_S, warmup_s=0.0, drain=drain,
                                       track_slots=True)
    return sim.run_grid(r_engine.Grid.cross(**AXES), rbank, strategy=strategy)


@functools.lru_cache(maxsize=None)
def _port_run(drain):
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=HORIZON_S, warmup_s=0.0, drain=drain,
                              track_slots=True, device="cpu")
    return sim.run_grid(Grid.cross(**AXES), tbank, strategy="vmap")


def _differing_leaves(port_states, ref_states):
    """{leaf name: differing lanes}; dtype and shape must match."""
    ref = _np_tree(ref_states)
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


def check_faulted_grid(drain):
    tres = _port_run(drain)
    assert tres.cfg.max_faults == 3 and tres.cfg.drain == drain
    rvmap, rmap = _ref_run(drain, "vmap"), _ref_run(drain, "map")
    assert _differing_leaves(tres.states, rvmap.states) == {}
    diff = _differing_leaves(tres.states, rmap.states)
    assert list(diff) == (["fused"] if drain else []), diff  # the map lanes never fuse
    st = tres.drain
    assert st == rvmap.drain
    assert {**st, "plan_fused": False} == rmap.drain
    # the schedules bit: crash aborts, failovers with stale reads, probes,
    # and (drained) windows stopped at fault rows
    assert st["abort_causes"]["crash"] > 0 and st["availability"] < 1.0
    assert st["failovers"] > 0 and st["stale_reads"] > 0
    assert int(tres.states.hb_count.sum()) > 0
    assert (st["window_stops"]["fault"] > 0) == drain
    for i, m in enumerate(tres.metrics):
        assert m["noops"] == 0, i


@pytest.mark.parametrize("drain", [False], ids=["single"])
def test_faulted_grid_matches_reference_lanes(drain):
    check_faulted_grid(drain)


# ---------------------------------------------------------------------------
# (c) the fault and heartbeat events on mid-run states
# ---------------------------------------------------------------------------

# (kind, endpoint_a, endpoint_b, stage, severity)
EVENT_CASES = {
    "crash_start": (KIND_CRASH, 0, 0, 0, 0),
    "crash_end": (KIND_CRASH, 1, 1, 1, 0),
    "mw_partition_start": (KIND_PARTITION, MW, 0, 0, 0),
    "mw_partition_end": (KIND_PARTITION, MW, 1, 1, 0),
    "mesh_partition_start": (KIND_PARTITION, 0, 1, 0, 0),
    "mw_degrade_start": (KIND_DEGRADE, MW, 1, 0, 5_000),
    "mw_degrade_end": (KIND_DEGRADE, MW, 0, 1, 8_000),
    "mesh_degrade_start": (KIND_DEGRADE, 1, 0, 0, 4_000),
}


def _mid_run_states():
    """The drained run's final states at 2 s (transactions in flight), as
    numpy leaves: a state in the middle of a longer run."""
    return _np_tree(_ref_run(True, "vmap").states)


def _event_state(case):
    """`_mid_run_states` with fault row 0 set to the case's row, and the
    state an end event meets (the DS down or the link cut since 150 ms)."""
    kind, a, b, stage, sev = EVENT_CASES[case]
    st = _mid_run_states()._asdict()
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in st.items()}
    now = st["now"]
    for name, v in (("fault_kind", kind), ("fault_ds", a), ("fault_peer", b), ("fault_sev", sev)):
        st[name][:, 0] = v
    st["fault_stage"][:, 0] = stage
    st["fault_recover"][:, 0] = now + 300_000
    st["fault_time"][:, 0] = now
    node = b if a == MW else a
    if stage == 1 and kind == KIND_CRASH:
        st["ds_down"][:, node] = True
    if stage == 1 and kind != KIND_DEGRADE:
        st["down_since"][:, node] = now - 150_000
        st["hb_time"][:, node] = now + 40_000
    if stage == 1 and kind == KIND_PARTITION:
        st["mw_heal"][:, node] = now
    if stage == 1 and kind == KIND_DEGRADE:
        st["tau_mw_eff"][:, node] = st["tau_true"][:, node] * sev // 1000
    return type(_mid_run_states())(**st)


@functools.lru_cache(maxsize=None)
def _ref_events(cfg):
    fault = jax.jit(jax.vmap(lambda s, f, a: r_fault_event(cfg, s, f, a)))
    hb = jax.jit(jax.vmap(lambda s, d, a: r_hb_event(cfg, s, d, a)))
    return fault, hb


def _active():
    B = _mid_run_states().now.shape[0]
    return np.arange(B) != B - 1  # the last lane stays as it was


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_fault_event_matches_reference(case):
    ref_state = _event_state(case)
    cfg = _ref_run(True, "vmap").cfg
    B = ref_state.now.shape[0]
    f, act = np.zeros(B, np.int32), _active()
    want = _np_tree(_ref_events(cfg)[0](ref_state, f, act))
    got = _fault_event(cfg, interop.state_from_numpy(ref_state), torch.zeros(B, dtype=torch.int64),
                       torch.from_numpy(act))
    for name, x in tree_leaves(got):
        r = want
        for part in name.split("."):
            r = getattr(r, part)
        assert x.numpy().dtype == r.dtype and np.array_equal(x.numpy(), r), name
    # the event did something in the active lanes, nothing in the last
    changed = [n for n, x in tree_leaves(got)
               if not np.array_equal(x.numpy()[:-1], _leaf(ref_state, n)[:-1])]
    assert "fault_stage" in changed, changed
    if case == "crash_start":
        assert "phase" in changed and "hs.t_cnt" in changed, changed  # victims aborted
    for n, x in tree_leaves(got):
        assert np.array_equal(x.numpy()[-1], _leaf(ref_state, n)[-1]), n


def _leaf(state, name):
    r = state
    for part in name.split("."):
        r = getattr(r, part)
    return np.asarray(r)


@pytest.mark.parametrize("down", [True, False], ids=["fires", "disarms"])
def test_hb_event_matches_reference(down):
    st = _event_state("crash_end")._asdict()
    st["ds_down"] = st["ds_down"].copy()
    st["ds_down"][:, 1] = down
    ref_state = type(_mid_run_states())(**st)
    cfg = _ref_run(True, "vmap").cfg
    B = ref_state.now.shape[0]
    d, act = np.ones(B, np.int32), _active()
    want = _np_tree(_ref_events(cfg)[1](ref_state, d, act))
    got = _hb_event(cfg, interop.state_from_numpy(ref_state), torch.ones(B, dtype=torch.int64),
                    torch.from_numpy(act))
    for name, x in tree_leaves(got):
        assert np.array_equal(x.numpy(), _leaf(want, name)), name
    fired = got.hb_count.numpy()[:, 1] - ref_state.hb_count[:, 1]
    assert list(fired) == [int(down)] * (B - 1) + [0]


# ---------------------------------------------------------------------------
# (d) the window plan on a faulted mid-run state
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=0)
def _ref_plan(cfg, bank, states):
    return jax.vmap(lambda s: r_window_plan(cfg, bank, s))(states)


def _plan_state():
    """The mid-run states with, per lane, fault row 0 due at the time of
    the lane's 4th event and the probe of DS 1 due at its 2nd event's time;
    DS 1 unreachable in even lanes (the probe fires), reachable in odd ones
    (it disarms)."""
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in _mid_run_states()._asdict().items()}
    B = st["now"].shape[0]
    flat = np.concatenate([st["term_time"], st["sub_time"].reshape(B, -1),
                           st["op_time"].reshape(B, -1)], 1)
    times = np.sort(flat, 1)
    st["fault_stage"][:, 0] = 0
    st["fault_kind"][:, 0] = KIND_CRASH
    st["fault_ds"][:, 0] = st["fault_peer"][:, 0] = 0
    st["fault_time"][:, 0] = times[:, 3]
    st["fault_recover"][:, 0] = times[:, 3] + 100_000
    st["hb_time"][:, 1] = times[:, 1]
    st["ds_down"][:, 1] = np.arange(B) % 2 == 0
    return type(_mid_run_states())(**st)


def test_window_plan_matches_reference_on_a_faulted_state():
    rres = _ref_run(True, "vmap")
    rcfg = dataclasses.replace(rres.cfg, lockstep=True, horizon_us=3_000_000)
    ref_state = _plan_state()
    ref = _np_tree(_ref_plan(rcfg, _banks()[0], ref_state))
    f = {k.name: getattr(rcfg, k.name) for k in dataclasses.fields(rcfg)}
    f["proto"] = PRESETS[rcfg.proto.name]
    cfg = SimConfig(**f)
    B = ref_state.now.shape[0]
    bank = lane_bank(interop.bank_from_numpy(_np_tree(_banks()[0]._asdict())), B, False)
    plan = _window_plan(cfg, bank, interop.state_from_numpy(ref_state))
    assert plan._fields == ref._fields
    for name, got, want in zip(plan._fields, plan, ref):
        got = got.numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert got.dtype == want.dtype or (got.dtype == np.int64 and want.dtype == np.int32), (
            name, got.dtype, want.dtype)
        lanes = [b for b in range(B) if not np.array_equal(got[b], want[b])]
        assert not lanes, f"{name} differs in lanes {lanes}"
    # the fault rows and probes took part: probes fire in the even lanes,
    # drain in some window, and a fault row stops one
    assert list(ref.hb_fire[:, 1]) == [b % 2 == 0 for b in range(B)]
    assert ref.win_hb.any() and (ref.stop_code == STOP_FAULT).any()


# ---------------------------------------------------------------------------
# (e) schedule validation (tests/core/test_faults.py's regression suite)
# ---------------------------------------------------------------------------

BAD_GRIDS = {
    "ds_out_of_range": [{"preset": "ssp", "faults": ((10, 5, 20),)}],
    "recover_before_crash": [{"preset": "ssp", "faults": ((30, 0, 20),)}],
    "recover_at_crash": [{"preset": "ssp", "faults": ((30, 0, 30),)}],
    "overlap_on_one_ds": [{"preset": "ssp", "faults": ((10, 0, 50), (20, 0, 60))}],
    "malformed_row": [{"preset": "ssp"}, {"preset": "ssp", "faults": ((10, 0),)}],
    "not_a_sequence": [{"preset": "ssp", "faults": 7}],
    "ragged": [{"preset": "ssp", "faults": ((10, 0, 20),)},
               {"preset": "geotp", "faults": ((10, 0, 20), (30, 1, 40))}],
    "missing_schedule": [{"preset": "ssp", "faults": ((10, 0, 20),)}, {"preset": "geotp"}],
    "unknown_kind": [{"preset": "ssp", "faults": ((10, 7, MW, 0, 20, 0),)}],
    "endpoint_a_out_of_range": [{"preset": "ssp", "faults": ((10, KIND_PARTITION, 4, 0, 20, 0),)}],
    "endpoint_b_out_of_range": [{"preset": "ssp", "faults": ((10, KIND_DEGRADE, MW, 2, 20, 900),)}],
    "self_link": [{"preset": "ssp"}, {"preset": "ssp", "faults": ((10, KIND_PARTITION, 1, 1, 20, 0),)}],
    "degrade_severity": [{"preset": "ssp", "faults": ((10, KIND_DEGRADE, MW, 1, 20, 0),)}],
    "partition_ends_first": [{"preset": "ssp", "faults": ((30, KIND_PARTITION, MW, 1, 20, 0),)}],
    "crash_over_mw_link": [{"preset": "ssp", "faults": ((10, 0, 50), (20, KIND_DEGRADE, MW, 0,
                                                                           60, 2000))}],
    "replica_tau_length": [{"preset": "ssp", "replica_tau": (1000,)}],
}


@pytest.mark.parametrize("case", sorted(BAD_GRIDS))
def test_grid_fault_validation_matches_reference(case):
    cells = BAD_GRIDS[case]
    kw = dict(default_rtt_ms=RTT)
    with pytest.raises(ValueError) as want:
        r_engine.Grid(cells, **kw)
    with pytest.raises(ValueError) as got:
        Grid(cells, **kw)
    assert str(got.value) == str(want.value)
    assert f"cell {len(cells) - 1}" in str(got.value)


def test_grid_fault_axes_match_reference():
    kw = dict(preset="geotp", rtt_ms=RTT, theta=0.9)
    for faults in (((10, 0, 20), (30, 1, 40)), [[(10, 0, 20)], [(30, 1, 40)]],
                   ((10, 0, 20), (INF_US, 0, INF_US)), PART_HEAVY):
        want, got = r_engine.Grid.cross(faults=faults, **kw), Grid.cross(faults=faults, **kw)
        assert got.cells == want.cells and got.max_faults == want.max_faults
        assert [got.labels(i) for i in range(len(got))] == [want.labels(i) for i in range(len(want))]
        rw = interop.worlds_from_numpy(_np_tree(want.worlds()))
        for (name, x), (_, y) in zip(tree_leaves(got.worlds()), tree_leaves(rw)):
            assert x.dtype == y.dtype and torch.equal(x, y), name


def test_simulator_derives_max_faults_from_the_grid():
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.05, warmup_s=0.0, device="cpu")
    res = sim.run_grid(Grid.cross(preset="geotp", rtt_ms=RTT, faults=((20_000, 0, 40_000),)), tbank,
                       strategy="vmap")
    assert res.cfg.max_faults == 1 and sim.cfg.max_faults == 0
    assert res.states.fault_stage.tolist() == [[2]]
    res0 = sim.run_grid(Grid.cross(preset="geotp", rtt_ms=RTT), tbank, strategy="vmap")
    assert res0.cfg.max_faults == 0 and res0.drain["availability"] == 1.0
