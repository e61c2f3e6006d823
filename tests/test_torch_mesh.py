"""The port's placement table and its worlds mesh (`strategy="mesh"`)
against the reference, on the CPU.

1. `resolve_strategy` is the reference's decision table, point by point
   (mesh when more than one device is visible, vmap on one accelerator, map
   on the CPU, explicit pass-through, unknown raises), and so are
   `mesh_device_count` and `placement_cfg`.
2. With the census (`launch.mesh.local_devices`) patched to 4 CPU devices,
   the port's form of the reference's
   ``--xla_force_host_platform_device_count``: a 3-cell grid under
   ``auto`` (resolved to the mesh), a 5-cell grid (padded to 8 lanes, 3 of
   them padding), a grid with per-cell banks and a mesh `resume` each
   equal the reference's `strategy="map"` run on every final leaf, with
   the metrics and the drain telemetry equal: no padding lane leaks out.
   The reference's own tests hold its mesh equal to its map.
3. The card's form of a slice (the lockstep step, which `auto` picks for
   one card) run over 4 slices on the CPU equals the port's vmap run on
   every leaf, `fused` included, with the steps summed over the slices.
4. `RunResult.save` records the resolved strategy and the mesh's device
   count beside the requested strategy.

Every state comparison is exact. Reference compiles are cached per process.
"""

import functools

import pytest
import torch

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro.core.engine import placement as r_placement
from repro_torch.core import workloads as t_wl
from repro_torch.core.engine import (
    STRATEGIES, Grid, Simulator, batch, mesh_device_count, placement, placement_cfg,
    resolve_strategy,
)
from repro_torch.core.engine.state import tree_leaves
from repro_torch.launch import mesh as launch_mesh
from test_torch_engine import _rows_equal, assert_states_equal
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, K, D, N = 8, 4, 2, 32
RTT = (10.0, 100.0)
NDEV = 4
CPU = torch.device("cpu")


@pytest.fixture
def four_devices(monkeypatch):
    """The census stands 4 CPU devices in for the host's one."""
    monkeypatch.setattr(launch_mesh, "local_devices", lambda device=None: [CPU] * NDEV)


@functools.lru_cache(maxsize=None)
def _banks(seed=0):
    kw = dict(num_ds=D, records_per_node=2000, ops_per_txn=K, dist_ratio=0.5, theta=0.9,
              seed=seed)
    return (r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), T, N),
            t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), T, N))


GRID3 = [
    dict(preset="ssp", rtt_ms=RTT, jitter_milli=0),
    dict(preset="geotp", rtt_ms=RTT, jitter_milli=30, seed=1),
    dict(preset="chiller", rtt_ms=(20.0, 80.0), jitter_milli=0),
]
GRID5 = [dict(preset="ssp", rtt_ms=RTT, seed=s) for s in range(5)]
BANKED = [dict(preset=p, rtt_ms=RTT) for p in ("ssp", "geotp", "chiller")]


# ---------------------------------------------------------------------------
# 1. the decision table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_auto_is_mesh_on_multiple_devices(n, backend):
    want = r_placement.resolve_strategy("auto", device_count=n, backend=backend)
    assert resolve_strategy("auto", device_count=n, backend=backend) == want == "mesh"


@pytest.mark.parametrize("backend", ["gpu", "tpu"])
def test_auto_is_vmap_on_one_accelerator(backend):
    want = r_placement.resolve_strategy("auto", device_count=1, backend=backend)
    assert resolve_strategy("auto", device_count=1, backend=backend) == want == "vmap"


def test_auto_is_map_on_the_cpu(four_devices, monkeypatch):
    assert resolve_strategy("auto", device_count=1, backend="cpu") == "map"
    assert r_placement.resolve_strategy("auto", device_count=1, backend="cpu") == "map"
    # the defaults: the census of the device's type and its backend
    assert resolve_strategy("auto", device=CPU) == "mesh"
    monkeypatch.setattr(launch_mesh, "local_devices", lambda device=None: [CPU])
    assert resolve_strategy("auto", device=CPU) == "map"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_explicit_strategy_passes_through(strategy):
    assert STRATEGIES == r_engine.STRATEGIES
    assert resolve_strategy(strategy, device_count=8, backend="tpu") == strategy
    assert resolve_strategy(strategy, device_count=1, backend="cpu") == strategy


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="pmap"):
        resolve_strategy("pmap")


def test_mesh_device_count(four_devices):
    assert mesh_device_count("map") == 1
    assert mesh_device_count("vmap", mesh_devices=4) == 1
    assert mesh_device_count("mesh", mesh_devices=3, device=CPU) == 3
    assert mesh_device_count("mesh", device=CPU) == NDEV
    with pytest.raises(ValueError, match=f"asked for {NDEV + 1} devices, host has {NDEV}"):
        mesh_device_count("mesh", mesh_devices=NDEV + 1, device=CPU)
    with pytest.raises(ValueError, match="asked for 0 devices"):
        mesh_device_count("mesh", mesh_devices=0, device=CPU)


def test_mesh_device_count_on_the_unpatched_cpu_is_one():
    assert launch_mesh.local_devices("cpu") == [CPU]
    assert mesh_device_count("mesh", device="cpu") == 1
    with pytest.raises(ValueError, match="asked for 2 devices, host has 1"):
        Simulator(2, 2, 2, 4, device="cpu").run_grid(
            Grid.cross(preset="ssp", rtt_ms=(0.0, 1.0)), _banks()[1], strategy="mesh",
            mesh_devices=2)


def test_placement_cfg_lockstep_only_where_the_lanes_lockstep():
    cfg = Simulator.from_bank(_banks()[1], horizon_s=0.1, device="cpu").cfg
    assert not cfg.lockstep
    assert placement_cfg(cfg, "vmap").lockstep
    assert placement_cfg(cfg, "map") == cfg
    # the mesh's slices run what auto picks for one device of the type
    assert placement_cfg(cfg, "mesh", CPU) == cfg
    assert placement_cfg(cfg, "mesh", "cuda").lockstep
    assert placement.slice_strategy(CPU) == "map"


# ---------------------------------------------------------------------------
# 2. the mesh on 4 patched CPU devices vs the reference's map lanes
# ---------------------------------------------------------------------------


def _metrics_equal(a, b):
    _rows_equal([dict(m) for m in a], [dict(m) for m in b])


@functools.lru_cache(maxsize=None)
def _ref(case):
    """The reference's map runs of the mesh tests (its tests hold its mesh
    equal to them)."""
    rbank = _banks()[0]
    if case == "grid3":
        sim = r_engine.Simulator.from_bank(rbank, horizon_s=0.5, warmup_s=0.0)
        return sim.run_grid(r_engine.Grid(GRID3), rbank, strategy="map")
    if case == "banked":
        banks = [_banks(s)[0] for s in (0, 1, 2)]
        sim = r_engine.Simulator.from_bank(banks[0], horizon_s=0.5, warmup_s=0.0)
        return sim.run_grid(r_engine.Grid(BANKED, banks=banks), strategy="map")
    sim = r_engine.Simulator.from_bank(rbank, horizon_s=0.25, warmup_s=0.0)
    res = sim.run_grid(r_engine.Grid(GRID5), rbank, strategy="map")
    if case == "grid5":
        return res
    return sim.resume(res, horizon_s=0.5)  # "resume"


def _held(tres, rres):
    assert len(tres.metrics) == len(rres.metrics)
    assert_states_equal(tres.states, rres.states)
    _metrics_equal(tres.metrics, rres.metrics)
    assert tres.drain == rres.drain
    assert [r["preset"] for r in tres.rows()] == [r["preset"] for r in rres.rows()]


def test_auto_mesh_equals_the_reference_map(four_devices):
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.5, warmup_s=0.0, device="cpu")
    res = sim.run_grid(Grid(GRID3), tbank)
    assert (res.strategy, res.strategy_resolved, res.mesh_devices) == ("auto", "mesh", NDEV)
    assert not res.cfg.lockstep  # the CPU's slices run the map lanes
    _held(res, _ref("grid3"))


def test_padded_mesh_and_its_resume_equal_the_reference_map(four_devices):
    """5 cells on 4 devices: 8 lanes, 3 of them padding, which no metric,
    drain telemetry or row sees; then the mesh resume, which keeps the
    mesh's device count and steps the result's own tensors."""
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.25, warmup_s=0.0, device="cpu")
    res = sim.run_grid(Grid(GRID5), tbank, strategy="mesh", mesh_devices=NDEV)
    assert res.mesh_devices == NDEV and len(res.metrics) == 5 and len(res.rows()) == 5
    assert res.states.now.shape[0] == 5
    _held(res, _ref("grid5"))
    before = {n: x for n, x in tree_leaves(res.states)}
    res2 = sim.resume(res, horizon_s=0.5)
    assert (res2.strategy_resolved, res2.mesh_devices) == ("mesh", NDEV)
    assert all(x is before[n] for n, x in tree_leaves(res2.states))  # in place
    _held(res2, _ref("resume"))


def test_per_cell_banks_split_with_the_worlds(four_devices):
    banks = [_banks(s)[1] for s in (0, 1, 2)]
    sim = Simulator.from_bank(banks[0], horizon_s=0.5, warmup_s=0.0, device="cpu")
    res = sim.run_grid(Grid(BANKED, banks=banks), strategy="mesh", mesh_devices=2)
    assert res.mesh_devices == 2 and res.bank_batched
    _held(res, _ref("banked"))


# ---------------------------------------------------------------------------
# 3. the card's slices (the lockstep step) over 4 slices, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drain", [True, False], ids=["drained", "single-event"])
def test_lockstep_slices_equal_the_vmap_run(four_devices, monkeypatch, drain):
    """What a mesh of cards runs: each slice the lockstep step, every slice
    stepped before any is read. 5 cells on 4 slices equal one vmap run on
    every leaf, `fused` included, each slice stops on its own check, and
    the steps are the slices' summed."""
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.25, warmup_s=0.0, drain=drain,
                              device="cpu")
    whole = sim.run_grid(Grid(GRID5), tbank, strategy="vmap")
    monkeypatch.setattr(placement, "slice_strategy", lambda device: "vmap")
    calls = []
    real = batch._stepper

    def stepper(step, s):
        calls.append(int(s.now.shape[0]))
        return real(step, s)

    monkeypatch.setattr(batch, "_stepper", stepper)
    res = sim.run_grid(Grid(GRID5), tbank, strategy="mesh")
    assert res.cfg.lockstep and calls == [2, 2, 2, 2]
    for (name, x), (_, y) in zip(tree_leaves(res.states), tree_leaves(whole.states)):
        assert torch.equal(x, y), name
    _metrics_equal(res.metrics, whole.metrics)
    assert len(batch.run.slice_capture_s) == NDEV
    # each slice alone takes whole multiples of the check interval
    assert res.steps % batch._CHECK_EVERY == 0 and res.steps >= NDEV * batch._CHECK_EVERY


# ---------------------------------------------------------------------------
# 4. the record
# ---------------------------------------------------------------------------


def test_save_records_resolved_strategy_and_mesh_shape(four_devices, tmp_path):
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.1, warmup_s=0.0, device="cpu")
    res = sim.run_grid(Grid([dict(preset="ssp", rtt_ms=RTT)]), tbank, strategy="auto")
    assert res.strategy == "auto"
    assert res.strategy_resolved == resolve_strategy("auto", device=CPU) == "mesh"
    assert res.mesh_devices == mesh_device_count("mesh", device=CPU) == NDEV
    entry = res.save("placement_test", path=tmp_path / "BENCH.json")
    assert entry["strategy"] == "auto"
    assert entry["strategy_resolved"] == "mesh" and entry["mesh_devices"] == NDEV
    assert tuple(res.states.now.shape) == (1,) and res.metrics[0]["events"] > 0
