"""The port's continuation (`Simulator.resume`, `RunResult.with_states`) and
its bench file (`RunResult.save`, `runtime_env`, `load_bench`,
`record_bench`, `record_smoke`) against the reference, on the CPU.

* (a) fig11's online step at test scale: a run, then `with_states` with
  `tau_true` edited, then `resume` to a later horizon with warmup 0;
  drained, and single-event under a crash-heavy schedule, as a grid
  (`run_grid`): every final leaf bitwise the reference's `strategy="map"`
  lanes (every leaf but `fused` when drained: the map lanes never fuse),
  and the metrics equal; as single worlds (`run`, drained): each lane's
  chain equal to the same reference lane.
* (b) a drained run resumed under the crash-heavy schedule equals one
  uninterrupted run on every leaf but the five drain telemetry leaves (a
  window cut at the first horizon may merge in the uninterrupted run),
  with the metrics equal.
* (c) a leaf edited through `with_states` with another shape, dtype or
  device raises `ValueError` naming it.
* (d) `save`'s keys are the reference `save`'s, its three jax keys
  replaced by `runtime_env`'s and ``steps`` added; the bench records
  round-trip under `tmp_path`; `runtime_env` reads the card's name and
  power limit from nvidia-smi's line.

Every state comparison is exact. Reference compiles are cached per process.
"""

import dataclasses
import functools
import json
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro_torch.core import workloads as t_wl
from repro_torch.core.engine import (
    BENCH_FILE, Grid, Simulator, load_bench, record_bench, record_smoke, runtime_env,
)
from repro_torch.core.engine.state import tree_leaves
from test_torch_engine import _rows_equal, assert_states_equal
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, K, D, N = 4, 4, 2, 32
RTT = (10.0, 100.0)
H1, H2 = 0.15, 0.3  # the first horizon, then the resumed one
WARMUP_S = 0.05
# fig11's edit: the true latencies move between segments
NEW_TAU = [(5_000, 140_000), (60_000, 20_000)]
# crash / recovery cycles inside the test horizons ((t_crash_us, ds, t_recover_us))
CRASH_HEAVY = ((40_000, 0, 110_000), (140_000, 1, 230_000), (250_000, 0, 290_000))
TELEMETRY = ("drained", "windows", "win_stops", "fused", "chained")
CASES = {"drained": (True, None), "single-crash": (False, CRASH_HEAVY)}
JAX_KEYS = ("jax_version", "jax_backend", "jax_device_count")


@functools.lru_cache(maxsize=None)
def _banks():
    kw = dict(num_ds=D, records_per_node=2000, ops_per_txn=K, dist_ratio=0.5, theta=0.9, seed=0)
    return (r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), T, N),
            t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), T, N))


def _cells(faults):
    extra = {} if faults is None else {"faults": faults}
    return [dict(preset=p, rtt_ms=RTT, **extra) for p in ("ssp", "geotp")]


@functools.lru_cache(maxsize=None)
def _ref(case):
    """The reference's map lanes: run to H1, tau_true edited, resumed to H2."""
    drain, faults = CASES[case]
    rbank = _banks()[0]
    sim = r_engine.Simulator.from_bank(rbank, horizon_s=H1, warmup_s=WARMUP_S, drain=drain,
                                       track_slots=True)
    res = sim.run_grid(r_engine.Grid(_cells(faults)), rbank, strategy="map")
    res = res.with_states(res.states._replace(tau_true=jnp.asarray(NEW_TAU, jnp.int32)))
    return sim.resume(res, horizon_s=H2, warmup_s=0.0)


def _sim(drain):
    return Simulator.from_bank(_banks()[1], horizon_s=H1, warmup_s=WARMUP_S, drain=drain,
                               track_slots=True, device="cpu")


@functools.lru_cache(maxsize=None)
def _port(case):
    drain, faults = CASES[case]
    tbank = _banks()[1]
    sim = _sim(drain)
    res = sim.run_grid(Grid(_cells(faults)), tbank, strategy="vmap")
    res = res.with_states(res.states._replace(
        tau_true=torch.tensor(NEW_TAU, dtype=torch.int32)))
    return sim.resume(res, horizon_s=H2, warmup_s=0.0)


def _but(states, ref, names):
    return states._replace(**{n: getattr(ref, n) for n in names})


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_grid_matches_reference_map_lanes(case):
    drain, faults = CASES[case]
    tres, rres = _port(case), _ref(case)
    assert tres.cfg.horizon_us == rres.cfg.horizon_us == 300_000
    assert tres.cfg.warmup_us == 0 and tres.cfg.lockstep and tres.cfg.drain == drain
    assert tres.cfg.max_faults == (0 if faults is None else len(faults))
    assert tres.strategy == tres.strategy_resolved == "vmap" and tres.batched
    assert torch.equal(tres.states.tau_true, torch.tensor(NEW_TAU, dtype=torch.int32))
    ref_states = rres.states
    if drain:  # the map lanes never fuse
        ref_states = ref_states._replace(fused=jnp.asarray(tres.states.fused.numpy()))
        assert int(tres.states.fused.sum()) > 0
    assert_states_equal(tres.states, ref_states)
    _rows_equal(tres.metrics, [dict(m) for m in rres.metrics])
    if faults is not None:
        assert tres.drain["abort_causes"]["crash"] > 0


def test_resumed_single_worlds_match_reference_lanes():
    """`run` (one lane, states [1, ...]) then `with_states` and `resume`:
    each world's chain equals its lane of the reference's map grid."""
    tbank = _banks()[1]
    grid = Grid(_cells(None))
    rres = _ref("drained")
    sim = _sim(True)
    for i in range(len(grid)):
        res = sim.run(grid.world(i), tbank)
        assert not res.batched and res.states.now.shape == (1,)
        res = res.with_states(res.states._replace(
            tau_true=torch.tensor([NEW_TAU[i]], dtype=torch.int32)))
        res = sim.resume(res, horizon_s=H2, warmup_s=0.0)
        assert not res.batched and res.states.now.shape == (1,)
        lane = r_engine.world_index(rres.states, i)
        lane = lane._replace(fused=jnp.asarray(res.world(0).fused.numpy()))
        want = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], lane)
        assert_states_equal(res.states, want)
        _rows_equal(res.metrics, [dict(rres.metrics[i])])


def test_resume_equals_one_uninterrupted_run():
    """H1 then H2 equals one run to H2 but for the drain telemetry (the
    reference's TestResume convention), faults included."""
    tbank = _banks()[1]
    grid = Grid(_cells(CRASH_HEAVY))
    sim = Simulator.from_bank(tbank, horizon_s=H1, warmup_s=0.0, device="cpu")
    res = sim.resume(sim.run_grid(grid, tbank, strategy="vmap"), horizon_s=H2)
    whole = Simulator.from_bank(tbank, horizon_s=H2, warmup_s=0.0, device="cpu").run_grid(
        grid, tbank, strategy="vmap")
    assert res.cfg == whole.cfg
    _rows_equal(res.metrics, whole.metrics)
    assert res.drain["abort_causes"]["crash"] > 0
    for (name, x), (_, y) in zip(tree_leaves(_but(res.states, whole.states, TELEMETRY)),
                                 tree_leaves(whole.states)):
        assert torch.equal(x, y), name
    # an old horizon is a no-op: every pending event already lies beyond it
    again = sim.resume(res)
    assert again.steps == 0
    _rows_equal(again.metrics, res.metrics)


@pytest.mark.parametrize("what", ["shape", "dtype", "device"])
def test_resume_rejects_an_edited_leaf_of_another_layout(what):
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.02, warmup_s=0.0, device="cpu")
    res = sim.run(Grid(_cells(None)).world(0), tbank)
    tau = res.states.tau_true
    bad = {"shape": tau[0],  # fig11's [D] against the single world's [1, D]
           "dtype": tau.to(torch.int64),
           "device": torch.empty(tau.shape, dtype=tau.dtype, device="meta")}[what]
    with pytest.raises(ValueError, match=rf"result\.states\.tau_true has {what}"):
        sim.resume(res.with_states(res.states._replace(tau_true=bad)), horizon_s=0.04)
    assert sim.resume(res, horizon_s=0.04).metrics[0]["events"] >= res.metrics[0]["events"]


def test_save_keys_are_the_reference_keys(tmp_path):
    tres, rres = _port("drained"), _ref("drained")
    got = tres.save("resume_test", tmp_path / "port.json")
    want = rres.save("resume_test", path=tmp_path / "ref.json")
    env = runtime_env("cpu")
    assert set(got) == (set(want) - set(JAX_KEYS)) | set(env) | {"steps"}
    assert not set(JAX_KEYS) & set(got)
    for k in ("worlds", "terminals", "events", "horizon_s", "drain_hit_rate", "window_stops",
              "mean_window_len", "loop_iters", "availability", "wan_rounds", "mesh_devices"):
        assert got[k] == want[k], k
    assert got["steps"] == tres.steps and got["strategy_resolved"] == "vmap"
    assert got["plan_fused"] and not want["plan_fused"]  # the map lanes never fuse
    assert {k: got[k] for k in env} == env
    assert load_bench(tmp_path / "port.json")["sweeps"]["resume_test"] == json.loads(
        json.dumps(got))


def test_bench_records_round_trip(tmp_path):
    path = tmp_path / "sub" / "BENCH_engine.json"
    assert load_bench(path) == {"sweeps": {}, "smoke": {}}
    a = record_bench("a", {"events": 1}, path, device="cpu")
    b = record_bench("b", {"events": 2, "nested": {"x": 1.5}}, path, device="cpu")
    s = record_smoke({"worlds": 16}, path, device="cpu")
    bench = load_bench(path)
    assert bench == {"sweeps": {"a": a, "b": b}, "smoke": s}
    env = runtime_env("cpu")
    assert env == {"torch_version": torch.__version__, "torch_cuda": torch.version.cuda,
                   "torch_backend": "cpu", "torch_device_count": 1, "device_name": "cpu",
                   "power_limit": None}
    assert s == {"worlds": 16, **env}
    record_smoke({"worlds": 4}, path, device="cpu")  # the smoke entry is replaced
    assert load_bench(path)["smoke"]["worlds"] == 4 and load_bench(path)["sweeps"] == bench[
        "sweeps"]
    assert BENCH_FILE.as_posix() == "results/bench_torch/BENCH_engine.json"


def test_runtime_env_reads_the_card_from_nvidia_smi(monkeypatch):
    line = "NVIDIA H100 80GB HBM3, 700.00 W"
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=line + "\n", stderr="")

    uuid = "0c5b6a3e-7d1f-4e2a-9b8c-1d2e3f405162"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(uuid=uuid))
    monkeypatch.setattr(subprocess, "run", fake_run)
    env = runtime_env("cuda")
    assert env["device_name"] == "NVIDIA H100 80GB HBM3" and env["power_limit"] == "700.00 W"
    assert env["torch_backend"] == "cuda" and env["torch_device_count"] == 1
    # the card is the one that ran, picked by its UUID: nvidia-smi's row
    # order ignores CUDA_VISIBLE_DEVICES
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                      "-i", f"GPU-{uuid}"]]
    line = line + "\nNVIDIA H100 80GB HBM3, 500.00 W"
    with pytest.raises(RuntimeError, match="printed 2 lines"):
        runtime_env("cuda")


def test_grid_with_banks_and_run_result_with_states():
    tbank = _banks()[1]
    grid = Grid(_cells(None))
    g2 = grid.with_banks([tbank, tbank])
    assert g2.cells == grid.cells and g2.banks == [tbank, tbank] and grid.banks is None
    with pytest.raises(ValueError, match="2 banks for 1 cells"):
        Grid(grid.cells[:1]).with_banks([tbank, tbank])
    res = _port("single-crash")
    other = res.with_states(res.states._replace(now=res.states.now + 1))
    assert other.states is not res.states and other.metrics is res.metrics
    assert dataclasses.replace(other, states=res.states).layout == res.layout
    assert np.array_equal(other.states.now.numpy(), res.states.now.numpy() + 1)
