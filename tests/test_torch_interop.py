"""Data carried across with `repro_torch.interop`, and a step-by-step
differential: reference states taken from the middle of a run are stepped
in both packages and compared leaf by leaf after every step (bitwise; the
first differing leaf is named). Two reference compiles: the vmapped
`_omni_step` and the single-world `Simulator.run`."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro.core.engine.omni import _omni_step as r_omni_step
from repro.core.protocols import PRESETS as R_PRESETS
from repro_torch import interop
from repro_torch.core import workloads as t_wl
from repro_torch.core.engine import Grid, Simulator, make_world
from repro_torch.core.engine.batch import lane_bank
from repro_torch.core.engine.omni import _omni_step
from repro_torch.core.engine.state import SimConfig, tree_leaves
from repro_torch.core.protocols import PRESETS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, K, D, N = 4, 5, 4, 16
STEPS = 40


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _assert_equal(port_state, ref_state, where):
    ref = _np_tree(ref_state)
    for name, x in tree_leaves(port_state):
        r = ref
        for part in name.split("."):
            r = getattr(r, part)
        got = x.numpy()
        if got.dtype != r.dtype or not np.array_equal(got, r):
            pytest.fail(f"{where}: first differing leaf {name}")


def _ref_bank(theta=1.2):
    kw = dict(num_ds=D, records_per_node=500, ops_per_txn=K, dist_ratio=0.5, theta=theta)
    return r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), T, N)


def test_bank_and_worlds_from_numpy():
    rbank = _ref_bank()
    tbank = interop.bank_from_numpy(_np_tree(rbank._asdict()))
    kw = dict(num_ds=D, records_per_node=500, ops_per_txn=K, dist_ratio=0.5, theta=1.2)
    own = t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), T, N)
    for f in t_wl.BANK_ARRAYS:
        np.testing.assert_array_equal(getattr(tbank, f).numpy(), getattr(own, f).numpy())
    assert (tbank.num_ds, tbank.num_records) == (own.num_ds, own.num_records)
    cells = dict(preset=tuple(sorted(R_PRESETS)), jitter_milli=(0, 30))
    rw = interop.worlds_from_numpy(_np_tree(r_engine.Grid.cross(**cells).worlds()))
    tw = Grid.cross(**cells).worlds()
    for (name, a), (_, b) in zip(tree_leaves(rw), tree_leaves(tw)):
        assert a.dtype == b.dtype and a.equal(b), name


@functools.partial(jax.jit, static_argnums=0)
def _ref_steps(cfg, bank, states):
    return jax.vmap(lambda s: r_omni_step(cfg, bank, s))(states)


def test_mid_run_states_step_identically():
    rbank = _ref_bank()
    rsim = r_engine.Simulator.from_bank(rbank, horizon_s=0.2, warmup_s=0.0, drain=False,
                                        track_slots=True)
    rres = rsim.run_grid(r_engine.Grid.cross(preset=tuple(sorted(R_PRESETS))), rbank,
                         strategy="map")
    rcfg = dataclasses.replace(rres.cfg, lockstep=True)
    ref = rres.states
    port = interop.state_from_numpy(_np_tree(ref))
    _assert_equal(port, ref, "after conversion")
    back = interop.state_to_numpy(port)
    np.testing.assert_array_equal(back["hs"]["w_lat"], np.asarray(ref.hs.w_lat))
    f = {k.name: getattr(rcfg, k.name) for k in dataclasses.fields(rcfg)}
    f["proto"] = PRESETS[rcfg.proto.name]
    cfg = SimConfig(**f)
    bank = lane_bank(interop.bank_from_numpy(_np_tree(rbank._asdict())), 12, False)
    for step in range(STEPS):
        ref = _ref_steps(rcfg, rbank, ref)
        port = _omni_step(cfg, bank, port)
        _assert_equal(port, ref, f"step {step + 1}")


def test_single_world_run_matches_reference():
    rbank = _ref_bank(0.9)
    tbank = interop.bank_from_numpy(_np_tree(rbank._asdict()))
    for preset in ("geotp", "opta"):
        rsim = r_engine.Simulator.from_bank(rbank, horizon_s=0.3, warmup_s=0.05, drain=False,
                                            track_slots=True)
        rres = rsim.run(r_engine.make_world(preset, jitter_milli=30), rbank)
        tsim = Simulator.from_bank(tbank, horizon_s=0.3, warmup_s=0.05, drain=False,
                                   track_slots=True, device="cpu")
        tres = tsim.run(make_world(preset, jitter_milli=30), tbank)
        assert not tres.batched and len(tres) == 1
        w = tres.world(0)
        _assert_equal(jax.tree_util.tree_map(lambda x: x[None], w),
                      jax.tree_util.tree_map(lambda x: np.asarray(x)[None], rres.states),
                      preset)
        for k, v in rres.metrics[0].items():
            assert tres.metrics[0][k] == v or (v != v and tres.metrics[0][k] != tres.metrics[0][k]), k
