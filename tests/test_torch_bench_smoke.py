"""The port's smoke path (`repro_torch.bench.smoke`) and `chip_smoke.py`'s
reference tables against the reference's own cells, on the CPU.

* The smoke's constants and each leg's cells are the reference smoke's
  (`benchmarks/run.py`); the test imports the reference, the port does not.
* Each guard fires on crafted telemetry with the reference's message, and
  holds on telemetry that passes.
* A small smoke (T = 8, 0.4 s, seeds 0-1, the fault and partition rows
  moved inside that horizon) and the reference's own smoke at the same
  constants both pass their guards. The port's entry has the reference
  entry's keys, less the seed comparator's two, plus `runtime_env`'s and
  ``map_leg``, and one sweep a leg; every key that both measure the same
  way (the drain telemetry, the fault and partition fields, each
  protocol's events, WAN rounds, WAN rounds a transaction and fast
  commits) equals the reference's.
* ``python -m repro_torch.bench.smoke`` without a card raises.
* `chip_smoke`'s FIG11_ONLINE_REF and SMOKE_REF rows are fig11's online
  segments and the smoke's cells, in order.

Run as a script, it prints those two tables from the JAX reference on the
CPU (fig11's online loop, single-world `run` / `resume`, and the smoke's
cells through `benchmarks.common.run_sweep(strategy="map", record=False)`;
nothing is written):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_bench_smoke.py
"""

import ast
import inspect
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import figures as r_figures  # noqa: E402
from benchmarks import run as r_run  # noqa: E402
from repro_torch.bench import smoke  # noqa: E402
from repro_torch.core.engine import load_bench, runtime_env  # noqa: E402

CONSTANTS = ("SMOKE_PRESETS", "SMOKE_SEEDS", "SMOKE_T", "SMOKE_HORIZON_S", "SMOKE_WARMUP_S",
             "SMOKE_FAULTS", "SMOKE_PARTITIONS", "SMOKE_REPLICAS", "SMOKE_PROTOCOLS")


def _assigned(fn, name):
    """The expression assigned to `name` inside the reference function `fn`."""
    for node in ast.walk(ast.parse(inspect.getsource(fn))):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            return node.value
    raise LookupError(f"{fn.__name__} assigns no {name}")


def fig11_segments():
    """fig11's online segments, from `benchmarks/figures.py`'s source."""
    return tuple(tuple(r) for r in ast.literal_eval(_assigned(r_figures.fig11_dynamic, "segs")))


def ref_entry_keys():
    """The keys of the reference smoke's entry (`benchmarks/run.py::smoke`)."""
    return {k.value for k in _assigned(r_run.smoke, "entry").keys}


def ref_leg_cells():
    """The reference smoke's cells and warmups, as `benchmarks/run.py`
    builds them; its map leg is the port's grid and single legs."""
    r = r_run
    grid = [dict(preset=p, seed=sd) for sd in r.SMOKE_SEEDS for p in r.SMOKE_PRESETS]
    return {
        "grid": (grid, r.SMOKE_WARMUP_S),
        "single": (grid, r.SMOKE_WARMUP_S),
        "faults": ([dict(preset=p, seed=0, faults=r.SMOKE_FAULTS) for p in ("ssp", "geotp")],
                   r.SMOKE_WARMUP_S),
        "partitions": ([dict(preset=p, seed=0, faults=r.SMOKE_PARTITIONS, **r.SMOKE_REPLICAS)
                        for p in ("ssp", "geotp")], r.SMOKE_WARMUP_S),
        "protocols": ([dict(preset=p, seed=sd) for sd in r.SMOKE_SEEDS[:2]
                       for p in r.SMOKE_PROTOCOLS], 0.0),
    }


@pytest.mark.parametrize("name", CONSTANTS)
def test_smoke_constants_are_the_reference_smoke_constants(name):
    assert getattr(smoke, name) == getattr(r_run, name)


def test_legs_are_the_reference_smoke_cells():
    port, ref = smoke.leg_cells(), ref_leg_cells()
    assert list(port) == list(smoke.LEGS) == list(ref)
    for name in smoke.LEGS:
        cells, warmup_s, drain = port[name]
        assert (cells, warmup_s) == ref[name], name
        assert drain == (name != "single"), name


_PART_OK = {"availability": 0.83, "failovers": 8, "stale_reads": 30}
_FAULT_OK = {"availability": 0.88}
_COMMITS = [{"commits": 5}, {"commits": 7}]
_NO_COMMITS = [{"commits": 5}, {"commits": 0}]
_WAN_OK = {("fastc", 0): 1.2, ("ssp", 0): 3.0, ("fastc", 1): 1.3, ("ssp", 1): 2.9}
_ROW = {"events": 10, "commits": 3, "aborts": 1}
GUARD_CASES = {
    "partition-ok": (smoke.partition_guard, (_PART_OK, _COMMITS), None),
    "partition-full-availability": (smoke.partition_guard,
                                    ({**_PART_OK, "availability": 1.0}, _COMMITS), "PARTITION"),
    "partition-no-failover": (smoke.partition_guard, ({**_PART_OK, "failovers": 0}, _COMMITS),
                              "PARTITION"),
    "partition-no-stale-read": (smoke.partition_guard,
                                ({**_PART_OK, "stale_reads": 0}, _COMMITS), "PARTITION"),
    "partition-dead-cell": (smoke.partition_guard, (_PART_OK, _NO_COMMITS), "PARTITION"),
    "fault-ok": (smoke.fault_guard, (_FAULT_OK, _COMMITS), None),
    "fault-full-availability": (smoke.fault_guard, ({"availability": 1.0}, _COMMITS), "FAULT"),
    "fault-no-availability": (smoke.fault_guard, ({"availability": 0.0}, _COMMITS), "FAULT"),
    "fault-dead-cell": (smoke.fault_guard, (_FAULT_OK, _NO_COMMITS), "FAULT"),
    "protocol-ok": (smoke.protocol_guard, (_WAN_OK, (0, 1)), None),
    "protocol-tie": (smoke.protocol_guard, ({**_WAN_OK, ("fastc", 1): 2.9}, (0, 1)),
                     "PROTOCOL"),
    "protocol-above": (smoke.protocol_guard, ({**_WAN_OK, ("fastc", 0): 3.5}, (0, 1)),
                       "PROTOCOL"),
    "drain-ok": (smoke.drain_guard, ({"drain_hit_rate": 0.69},), None),
    "drain-off": (smoke.drain_guard, ({"drain_hit_rate": 0.0},), "LOCKSTEP DRAIN"),
    "legs-equal": (smoke.legs_equal_guard, ([{"preset": "ssp"}], [_ROW], [dict(_ROW)]), None),
    "legs-events-differ": (smoke.legs_equal_guard,
                           ([{"preset": "ssp"}], [_ROW], [{**_ROW, "events": 11}]),
                           "DRAIN PARITY"),
    "legs-aborts-differ": (smoke.legs_equal_guard,
                           ([{"preset": "ssp"}], [_ROW], [{**_ROW, "aborts": 0}]),
                           "DRAIN PARITY"),
}


# each message's head, as the reference prints it (the port's own guard has none)
REF_HEADS = {
    "PARTITION": "[smoke] PARTITION REGRESSION: typed schedule reported",
    "FAULT": "[smoke] FAULT REGRESSION: crash-heavy schedule reported",
    "PROTOCOL": "[smoke] PROTOCOL REGRESSION: FASTC wan/txn not strictly below",
    "LOCKSTEP DRAIN": "[smoke] LOCKSTEP DRAIN REGRESSION: vmap drain hit rate is 0",
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guards_fire_on_crafted_telemetry(case):
    guard, args, fires = GUARD_CASES[case]
    msg = guard(*args)
    if fires is None:
        assert msg is None
        return
    assert msg.startswith(f"[smoke] {fires} REGRESSION: ")
    head = REF_HEADS.get(fires)
    if head is not None:
        assert msg.startswith(head) and head in inspect.getsource(r_run.smoke)


# the smoke's constants at test size: the fault and partition rows lie inside
# the 0.4 s horizon, and the cut MW<->ds0 is long enough to fail reads over
SMALL = dict(
    SMOKE_SEEDS=(0, 1), SMOKE_T=8, SMOKE_HORIZON_S=0.4, SMOKE_WARMUP_S=0.1,
    SMOKE_FAULTS=((80_000, 0, 160_000), (190_000, 2, 300_000)),
    SMOKE_PARTITIONS=((10_000, 1, -1, 0, 380_000, 0), (120_000, 2, -1, 1, 320_000, 4_000)),
    SMOKE_REPLICAS=dict(replica_tau=(30_000,) * 4, repl_lag_us=50_000),
)
# the entry's keys that both smokes measure the same way (protocols: every
# field of a preset's record but its events/s)
SAME_KEYS = (
    "worlds", "terminals", "horizon_s", "events_batched", "drain_hit_rate",
    "drain_hit_rate_vmap", "mean_window_len", "window_stops", "chained",
    "scheduled_stop_share", "plan_fused_vmap", "loop_iters_vmap", "availability_fault",
    "abort_causes_fault", "commits_during_fault", "availability_partition",
    "failovers_partition", "stale_reads_partition", "max_staleness_us_partition", "protocols",
)
# wall-clock readings, and the map leg's loop count (the port's stand-in leg)
TIMED_KEYS = (
    "wall_batched_s", "events_per_sec_batched", "events_per_sec_map", "events_per_sec_vmap",
    "vmap_vs_map", "wall_fault_s", "wall_partition_s", "wall_protocols_s", "total_wall_s",
)
JAX_KEYS = ("jax_version", "jax_backend", "jax_device_count")


@pytest.fixture(scope="module")
def small_smokes(tmp_path_factory):
    """The port's smoke on the CPU and the reference's (`benchmarks/run.py::
    smoke`, its bench file moved to a temporary path) at SMALL: (the port's
    SmokeRun, its bench file, the reference's return code, its entry)."""
    from repro.core.engine import api as r_api

    tmp = tmp_path_factory.mktemp("smoke")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(smoke, name, value)
            mp.setattr(r_run, name, value)
        mp.setattr(r_api, "BENCH_FILE", tmp / "ref.json")
        rc_ref = r_run.smoke()
        run = smoke.smoke(tmp / "port.json", device="cpu")
    return run, tmp / "port.json", rc_ref, load_bench(tmp / "ref.json")["smoke"]


def test_tiny_smoke_records_the_reference_entry_keys(small_smokes):
    run, path, _, _ = small_smokes
    assert run.rc == 0
    env = runtime_env("cpu")
    assert set(smoke.LEFT_OUT) <= ref_entry_keys()
    assert set(run.entry) == (ref_entry_keys() - set(smoke.LEFT_OUT)) | set(env) | {"map_leg"}
    bench = load_bench(path)
    assert bench["smoke"] == run.entry
    assert sorted(bench["sweeps"]) == sorted(f"smoke_{n}" for n in smoke.LEGS)
    for name in smoke.LEGS:
        assert bench["sweeps"][f"smoke_{name}"]["steps"] == run.results[name].steps
    assert [m["events"] for m in run.results["grid"].metrics] == [
        m["events"] for m in run.results["single"].metrics]
    assert run.entry["events_batched"] == run.results["grid"].events > 0
    # the *_map keys read the single-event leg, and the entry says so
    assert run.entry["map_leg"] == smoke.MAP_LEG
    assert run.entry["loop_iters_map"] == run.results["single"].drain["loop_iters"]


def test_smoke_entry_keys_are_sorted_into_same_timed_and_left_out():
    ref = ref_entry_keys()
    groups = (SAME_KEYS, TIMED_KEYS, ("loop_iters_map",), smoke.LEFT_OUT)
    assert sorted(k for g in groups for k in g) == sorted(ref)


@pytest.mark.parametrize("key", SAME_KEYS)
def test_smoke_entry_equals_the_reference_smoke(small_smokes, key):
    run, _, rc_ref, ref = small_smokes
    assert rc_ref == 0 and run.rc == 0
    got, want = run.entry[key], ref[key]
    if key == "protocols":
        assert list(got) == list(want) == list(smoke.SMOKE_PROTOCOLS)
        for p in want:
            assert {k: v for k, v in got[p].items() if k != "events_per_sec"} == {
                k: v for k, v in want[p].items() if k != "events_per_sec"}, p
            assert got[p]["events_per_sec"] > 0
        assert got["fastc"]["wan_per_txn"] < got["ssp"]["wan_per_txn"]
        return
    assert got == want
    # the guards' fields are read at values that show a swap
    if key in ("failovers_partition", "stale_reads_partition", "commits_during_fault"):
        assert got > 0


def test_smoke_timed_keys_are_positive_and_the_jax_keys_absent(small_smokes):
    run, _, _, ref = small_smokes
    for k in TIMED_KEYS:
        assert run.entry[k] > 0 and ref[k] > 0, k
    assert not set(JAX_KEYS) & set(run.entry) and set(JAX_KEYS) <= set(ref)
    assert run.entry["failovers_partition"] != run.entry["stale_reads_partition"]


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.main(["--path", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()


def test_chip_smoke_tables_are_the_figure_and_smoke_cells():
    import chip_smoke
    from repro_torch.bench import figures

    # phase 5e runs fig11's online chain as the port's figures module does
    assert figures.FIG11_SEGMENTS == fig11_segments()
    assert figures.QUICK_T == r_figures.QUICK_T
    assert [(r[0], r[1]) for r in chip_smoke.FIG11_ONLINE_REF] == [
        (p, i) for p in ("ssp", "geotp") for i in range(len(fig11_segments()))]
    ref = ref_leg_cells()
    assert list(chip_smoke.SMOKE_REF) == list(ref)
    for name, rows in chip_smoke.SMOKE_REF.items():
        assert [(r[0], r[1]) for r in rows] == [(c["preset"], c["seed"]) for c in ref[name][0]]


# ---------------------------------------------------------------------------
# the reference's numbers for chip_smoke's tables (run as a script)
# ---------------------------------------------------------------------------


def ref_fig11_online():
    """fig11's online loop through the reference (`benchmarks/figures.py:
    177-210`, nothing saved): (preset, segment, events, commits, aborts,
    throughput_tps, final clock us) a segment."""
    import jax.numpy as jnp

    from benchmarks import common
    from repro.core import engine

    bank = common.ycsb_bank(r_figures.QUICK_T, theta=0.9, dist_ratio=0.6)
    sim = engine.Simulator.from_bank(bank, terminals=r_figures.QUICK_T, horizon_s=8.0,
                                     warmup_s=1.0)
    rows = []
    for preset in ("ssp", "geotp"):
        res = None
        for i, rtt in enumerate(fig11_segments()):
            tau = jnp.asarray([int(r * 1000) for r in rtt], jnp.int32)
            if res is None:
                world = engine.make_world(preset, tuple(map(float, rtt)), jitter_milli=30)
                res = sim.run(world, bank)
                m = dict(res.metrics[0])
            else:
                res = res.with_states(res.states._replace(tau_true=tau))
                base = int(res.states.commits)
                res = sim.resume(res, horizon_s=int(res.states.now) / 1e6 + 8.0, warmup_s=0.0)
                m = dict(res.metrics[0])
                m["throughput_tps"] = (int(res.states.commits) - base) / 8.0
            rows.append((preset, i, m["events"], m["commits"], m["aborts"], m["throughput_tps"],
                         int(res.states.now)))
    return rows


def ref_smoke():
    """Each smoke leg's (preset, seed, events, commits, aborts) through the
    reference's `run_sweep` on its map lanes, nothing recorded."""
    from benchmarks import common

    r = r_run
    banks = {sd: common.ycsb_bank(r.SMOKE_T, theta=0.9, dist_ratio=0.2, seed=sd)
             for sd in r.SMOKE_SEEDS}
    out = {}
    for name, (cells, warmup_s) in ref_leg_cells().items():
        if name == "single":
            out[name] = out["grid"]
            continue
        res = common.run_sweep(f"ref_{name}", cells, None, r.SMOKE_T,
                               banks=[banks[c["seed"]] for c in cells],
                               horizon_s=r.SMOKE_HORIZON_S, warmup_s=warmup_s, strategy="map",
                               record=False)
        out[name] = [(c["preset"], c["seed"], m["events"], m["commits"], m["aborts"])
                     for c, m in zip(cells, res.metrics)]
    return out


if __name__ == "__main__":
    print("FIG11_ONLINE_REF = [")
    for row in ref_fig11_online():
        print(f"    {row!r},")
    print("]")
    print("SMOKE_REF = {")
    for name, rows in ref_smoke().items():
        print(f"    {name!r}: {rows!r},")
    print("}")
