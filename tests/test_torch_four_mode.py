"""The port's four step modes, bitwise interchangeable, on the reference
differential's fixed-seed cases (on the CPU):

    step   = sequential single-event lanes   (lockstep=F, drain=F: step._step)
    drain  = sequential windowed drain       (lockstep=F, drain=T: apply._drain_step)
    omni   = lockstep single-event step      (lockstep=T, drain=F: omni._omni_step)
    fused  = lockstep windowed drain         (lockstep=T, drain=T: fused._omni_window)

* The six fixed seeds of `tests/core/test_differential.py`
  (`TestFixedSeedDifferential`; its workload generator `_params` is copied
  here verbatim): random presets, bank shapes, zero-RTT tie storms, jitter,
  crash / partition / degrade rows and clock skew, run to 0.5 s (cut from
  1.2 s; every fault kind still fires in some case). Every final leaf
  is equal between the four modes but the drain telemetry between drained
  and undrained modes (and `fused`, the lockstep drain's own counter,
  between the two drained modes, whose other telemetry agrees), and the
  step mode equals the reference's step mode on every leaf.
* `window._window_plan` on the sequential lanes against the reference's
  map route (one stable argsort, full ranks) on mid-run states: every
  field equal, the ranks and the per-slot values built from them compared
  where a window can read them (the candidate slots; the port's ranks
  saturate at PLAN_CAP elsewhere, as the reference's lockstep route's do),
  and `_apply_window` writes the same states from either plan.

The hypothesis tier of the reference differential is not run here.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro.core.engine.window import _window_plan as r_window_plan
from repro.core.protocols import PRESETS as R_PRESETS
from repro_torch.core import workloads as t_wl
from repro_torch.core.workloads import stack_banks
from repro_torch.core.engine import apply, window
from repro_torch.core.engine.batch import lane_bank, run
from repro_torch.core.engine.metrics import drain_stats
from repro_torch.core.engine.state import (
    KIND_CRASH, KIND_DEGRADE, KIND_PARTITION, MW, N_STOP_REASONS, SimConfig, init_state_world,
    _times_flat, make_world, stack_worlds, tree_leaves, tree_map,
)
from repro_torch.core.protocols import PRESETS
from repro_torch.core.engine import Grid, Simulator
from test_torch_engine import _rows_equal, assert_states_equal
import test_torch_resume as tr
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ---- tests/core/test_differential.py, verbatim ------------------------------
HORIZON_US = 1_200_000
MAX_FAULTS = 3  # static fault capacity; inert rows start past the horizon

# static pools: every generated case compiles into one of these cache keys
PRESET_POOL = ("ssp", "geotp", "fastc", "tiga")
SHAPE_POOL = ((8, 4, 2, 24), (4, 4, 2, 12))  # (terminals, ops, ds, txns)

_INERT_FAULT = (HORIZON_US * 2, KIND_CRASH, 0, 0, HORIZON_US * 2 + 1, 0)


def _params(seed: int) -> dict:
    """Deterministic workload parameters from an integer seed.

    Mirrors the hypothesis strategy below so fixed-seed tier-1 examples and
    generative runs draw from the identical space.
    """
    rng = np.random.RandomState(seed * 7919 + 13)
    shape = SHAPE_POOL[int(rng.randint(len(SHAPE_POOL)))]
    _, _, num_ds, _ = shape
    tie_heavy = bool(rng.randint(3) == 0)  # 1/3 of cases: zero-RTT tie storms
    if tie_heavy:
        rtt, jitter = (0.0,) * num_ds, 0
    else:
        rtt = tuple(float(rng.choice([5.0, 10.0, 40.0, 100.0, 150.0]))
                    for _ in range(num_ds))
        jitter = int(rng.choice([0, 30, 100]))
    faults = []
    for _ in range(int(rng.randint(MAX_FAULTS + 1))):
        kind = int(rng.choice([KIND_CRASH, KIND_PARTITION, KIND_DEGRADE]))
        t0 = int(rng.randint(50_000, HORIZON_US - 200_000))
        t1 = t0 + int(rng.randint(100_000, 800_000))
        ds = int(rng.randint(num_ds))
        if kind == KIND_CRASH:
            faults.append((t0, KIND_CRASH, ds, ds, t1, 0))
        elif kind == KIND_PARTITION:
            faults.append((t0, KIND_PARTITION, MW, ds, t1, 0))
        else:
            faults.append((t0, KIND_DEGRADE, MW, ds, t1,
                           int(rng.choice([2000, 5000, 8000]))))
    faults += [_INERT_FAULT] * (MAX_FAULTS - len(faults))
    return dict(
        preset=PRESET_POOL[int(rng.randint(len(PRESET_POOL)))],
        shape=shape,
        bank_seed=int(rng.randint(1000)),
        theta=float(rng.choice([0.5, 0.9, 1.3])),
        dist_ratio=float(rng.choice([0.2, 0.5, 0.9])),
        jitter=jitter,
        rtt=rtt,
        faults=tuple(faults),
        skew=int(rng.choice([0, 0, 50_000, 300_000])),
    )
# ------------------------------------------------------------------------------

SEEDS = range(6)
# the runs stop at 0.5 s, cut from the differential's 1.2 s for time: the
# cases' crash, partition and degrade rows still fire (asserted below)
RUN_HORIZON_US = 500_000
# (lockstep, drain) of each mode
MODES = {"step": (False, False), "drain": (False, True), "omni": (True, False),
         "fused": (True, True)}
TELEMETRY = ("drained", "windows", "win_stops", "fused", "chained")


def _setup(preset, shape, bank_seed, theta, dist_ratio, jitter, rtt, faults, skew):
    """(reference cfg, bank, world) and the port's, for one generated case."""
    t, k, d, n = shape
    bank_kw = dict(num_ds=d, records_per_node=512, ops_per_txn=k, dist_ratio=dist_ratio,
                   theta=theta, seed=bank_seed)
    world_kw = dict(jitter_milli=jitter, clock_skew_us=skew, faults=faults,
                    max_faults=MAX_FAULTS)
    cfg_kw = dict(terminals=t, max_ops=k, num_ds=d, bank_txns=n, warmup_us=0,
                  horizon_us=RUN_HORIZON_US, track_slots=True, max_faults=MAX_FAULTS)
    ref = (r_engine.SimConfig(proto=R_PRESETS[preset], **cfg_kw),
           r_wl.make_ycsb_bank(r_wl.YCSBConfig(**bank_kw), terminals=t, txns_per_terminal=n),
           r_engine.make_world(preset, rtt, **world_kw))
    port = (SimConfig(proto=PRESETS[preset], **cfg_kw),
            t_wl.make_ycsb_bank(t_wl.YCSBConfig(**bank_kw), terminals=t, txns_per_terminal=n),
            make_world(preset, rtt, **world_kw))
    return ref, port


def _leaves_equal(a, b, skip=()):
    bad = [n for (n, x), (_, y) in zip(tree_leaves(a), tree_leaves(b))
           if n not in skip and not (x.dtype == y.dtype and torch.equal(x, y))]
    assert not bad, bad


@functools.lru_cache(maxsize=None)
def _group(shape):
    """The seeds of one bank shape as the lanes of one run a mode: (seeds,
    their params, the reference's step-mode states, {mode: [B] states},
    the port's config and [B] bank). The map modes step the lanes one
    after another, the lockstep modes together."""
    seeds = [s for s in SEEDS if _params(s)["shape"] == shape]
    ps = [_params(s) for s in seeds]
    setups = [_setup(**p) for p in ps]
    refs = [r_engine._sim_world_fresh(dataclasses.replace(rcfg, drain=False), rbank, rworld)
            for (rcfg, rbank, rworld), _ in setups]
    cfg = setups[0][1][0]
    bank = stack_banks([port[1] for _, port in setups])
    worlds = stack_worlds([port[2] for _, port in setups])
    outs = {}
    for mode, (lockstep, drain) in MODES.items():
        c = dataclasses.replace(cfg, lockstep=lockstep, drain=drain)
        outs[mode], _ = run(c, lane_bank(bank, len(seeds), True), init_state_world(c, worlds))
    return seeds, ps, refs, outs, cfg, bank


def _lane(states, b):
    return tree_map(lambda x: x[b:b + 1], states)


@pytest.mark.parametrize("seed", SEEDS)
def test_four_modes_bitwise_and_equal_to_the_reference_step_mode(seed):
    seeds, _, refs, outs, _, _ = _group(_params(seed)["shape"])
    b = seeds.index(seed)
    out = {mode: _lane(s, b) for mode, s in outs.items()}
    step = out["step"]
    assert int(step.noops[0]) == 0 and int(step.iters[0]) > 0
    # the single-event modes: every leaf; drained vs undrained: but the
    # drain telemetry; the two drained modes: but `fused`
    _leaves_equal(out["omni"], step)
    for mode in ("drain", "fused"):
        _leaves_equal(out[mode], step, skip=TELEMETRY)
    _leaves_equal(out["drain"], out["fused"], skip=("fused",))
    assert int(out["drain"].fused[0]) == 0 and int(out["fused"].fused[0]) > 0
    for mode in ("step", "omni"):
        assert all(int(getattr(out[mode], n).sum()) == 0 for n in TELEMETRY), mode
    # the reference's step mode, every leaf
    assert_states_equal(step, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], refs[b]))
    # the drained modes' telemetry conserves the events
    st = drain_stats(out["drain"], horizon_us=RUN_HORIZON_US)
    assert sum(st["window_stops"].values()) == st["windows"]
    assert 0 <= st["chained"] <= st["drained_events"]
    assert st["drained_events"] + st["seq_events"] == st["events"] == int(step.iters[0])


def test_the_fixed_seeds_fire_every_fault_kind():
    """Every fault kind fires in some case at the cut horizon (a row past
    it never does), and some case is a zero-RTT tie storm."""
    fired = set()
    for shape in SHAPE_POOL:
        _, ps, _, outs, _, _ = _group(shape)
        for p, stage in zip(ps, outs["step"].fault_stage.tolist()):
            fired |= {row[1] for row, st in zip(p["faults"], stage) if st > 0}
    assert fired == {KIND_CRASH, KIND_PARTITION, KIND_DEGRADE}
    assert any(p["rtt"][0] == 0.0 for p in (_params(s) for s in SEEDS))


# ---------------------------------------------------------------------------
# the window plan on the sequential lanes against the reference's map route
# ---------------------------------------------------------------------------

PLAN_HORIZON_US = 2_000_000  # past the runs' horizon: windows form
# the per-slot fields built from the ranks (the iteration numbers are the
# hash salts): equal at the candidate slots, the only slots a window reads
SLOT_FIELDS = ("pos_term", "pos_sub", "pos_op", "iters_term", "iters_sub", "iters_op")


def _candidate_masks(plan, M, T, D, K):
    """[B, T] / [B, T, D] / [B, T, K] masks of the candidate slots (M: the
    event-time view's width)."""
    M0 = T + T * D + T * K
    hit = torch.zeros((plan.cand_i.shape[0], M), dtype=torch.bool).scatter_(1, plan.cand_i, True)
    B = hit.shape[0]
    return hit[:, :T], hit[:, T:T + T * D].reshape(B, T, D), hit[:, T + T * D:M0].reshape(B, T, K)


@pytest.mark.parametrize("shape", SHAPE_POOL, ids=lambda s: f"T{s[0]}")
def test_window_plan_map_lanes_match_reference_map_route(shape):
    """On the step mode's final states (the middle of a longer run), each
    lane's plan equals the reference's map-route plan (`lockstep=False`: a
    stable argsort with full ranks) of the reference's state on every field:
    the ranks and iteration numbers at the candidate slots (elsewhere the
    port's ranks are W and the reference's at least W), every other field
    whole. `_apply_window` writes the same states from either plan."""
    seeds, ps, refs, outs, cfg, bank = _group(shape)
    T, D, K = cfg.terminals, cfg.num_ds, cfg.max_ops
    B = len(seeds)
    setups = [_setup(**p)[0] for p in ps]
    rcfg = dataclasses.replace(setups[0][0], lockstep=False, horizon_us=PLAN_HORIZON_US)
    r_plan = jax.jit(r_window_plan, static_argnums=0)
    want = [jax.tree_util.tree_map(np.asarray, r_plan(rcfg, rbank, r))
            for (_, rbank, _), r in zip(setups, refs)]
    want = type(want[0])(*(np.stack(f) for f in zip(*want)))
    c = dataclasses.replace(cfg, lockstep=False, horizon_us=PLAN_HORIZON_US)
    s = outs["step"]
    got = window._window_plan(c, lane_bank(bank, B, True), s)
    assert got._fields == want._fields
    term_c, sub_c, op_c = _candidate_masks(got, _times_flat(s).shape[1], T, D, K)
    W = got.cand_i.shape[1]
    for name, x, y in zip(got._fields, got, want):
        y = torch.from_numpy(y)
        assert x.shape == y.shape, (name, x.shape, y.shape)
        assert x.dtype == y.dtype or (x.dtype == torch.int64 and y.dtype == torch.int32), name
        y = y.to(x.dtype)
        if name in SLOT_FIELDS:
            m = term_c if name.endswith("term") else (sub_c if "sub" in name else op_c)
            assert torch.equal(x[m], y[m]), name
            if name.startswith("pos"):
                assert bool((x[~m] == W).all() & (y[~m] >= W).all()), name
        else:
            assert torch.equal(x, y), name
    assert int(got.use.sum()) > 0
    ref_plan = type(got)(*(torch.from_numpy(y).to(x.dtype) for x, y in zip(got, want)))
    stop = (got.stop_code[:, None] == torch.arange(N_STOP_REASONS)).to(torch.int32)
    no = torch.zeros_like(got.use)
    applied = [apply._apply_window(
        c, s, v, v.win_term, v.win_sub, v.win_op, v.t_last, v.n_win, v.n_win, 1, stop,
        fused_inc=0, xcancel=False, xlel=0, xcommit=False,
        xrel=(no, v.cand_t_sub[:, 0], v.cand_d_sub[:, 0]), act_hb=v.win_hb,
        chained_inc=v.n_chained, act_fu=v.fu_win, act_pfu=v.pfu_win) for v in (got, ref_plan)]
    _leaves_equal(*applied)


def test_map_resume_matches_reference_map_resume():
    tbank = tr._banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=tr.H1, warmup_s=tr.WARMUP_S, drain=False,
                              track_slots=True, device="cpu")
    res = sim.run_grid(Grid(tr._cells(tr.CRASH_HEAVY)), tbank, strategy="map")
    events_h1 = res.events
    res = res.with_states(res.states._replace(
        tau_true=torch.tensor(tr.NEW_TAU, dtype=torch.int32)))
    res = sim.resume(res, horizon_s=tr.H2, warmup_s=0.0, strategy="map")
    rres = tr._ref("single-crash")
    assert res.strategy_resolved == rres.strategy_resolved == "map" and not res.cfg.lockstep
    assert res.cfg.horizon_us == rres.cfg.horizon_us
    assert_states_equal(res.states, rres.states)
    _rows_equal(res.metrics, [dict(m) for m in rres.metrics])
    assert res.drain["abort_causes"]["crash"] > 0
    assert res.steps == res.events - events_h1  # the resumed span's single events
