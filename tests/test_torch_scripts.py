"""The root scripts that drive the port on a card: `chip_smoke.py` times the
kernel at the launch shapes the lockstep step really gives it, and
`profile_step.py` accounts a profiled window correctly (run here on the CPU,
where it records host activity only). Both refuse to run without a card."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import scheduler, workloads
from repro_torch.core.engine import Grid, Simulator, batch, placement

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import profile_step  # noqa: E402

B, D, K = 3, 4, 5


def _grid():
    cfg = workloads.YCSBConfig(num_ds=D, records_per_node=1000, ops_per_txn=K, seed=0)
    bank = workloads.make_ycsb_bank(cfg, terminals=4, txns_per_terminal=8)
    return Grid([dict(preset=p) for p in ("ssp", "geotp", "scalardb")], banks=[bank] * B)


def _signature(args):
    return [(tuple(x.shape), x.dtype, bool(x.any())) for x in args]


def test_smoke_launch_shapes_are_the_steps(monkeypatch):
    """Each step calls the kernel once as Eq.9 and once as Eq.8; the smoke
    builds both launches with the same shapes, dtypes and all-zero parts."""
    seen = []
    real = scheduler.plan_dispatch

    def record(*args):
        seen.append(_signature(args))
        return real(*args)

    monkeypatch.setattr(scheduler, "plan_dispatch", record)
    grid = _grid()
    res = Simulator.from_bank(grid.banks[0], horizon_s=0.05, warmup_s=0.0,
                              device="cpu").run_grid(grid)
    assert len(seen) == 2 * res.steps
    launches = chip_smoke.step_launches(B, D, K, seed=0)
    want = [_signature(launches["eq9"]), _signature(launches["eq8"])]
    shapes = lambda sig: [(s, dt) for s, dt, _ in sig]  # noqa: E731
    assert [shapes(s) for s in seen[:2]] == [shapes(w) for w in want]
    # what the smoke's launches hold at zero, every step's launch holds at zero
    for i, got in enumerate(seen):
        for (_, _, got_any), (_, _, w_any) in zip(got, want[i % 2]):
            assert w_any or not got_any, f"call {i}"


def test_smoke_work_counts_these_inputs():
    eq9, eq8 = chip_smoke.step_launches(16, 4, 5, seed=99).values()
    nb9, ops9 = chip_smoke.geo_work(*eq9)
    nb8, ops8 = chip_smoke.geo_work(*eq8)
    assert (nb9, nb8) == (16 * 82, 16 * 69)
    assert ops9 == 3 * 16 + 12 * int(eq9[6].sum()) + 16
    assert ops8 == 3 * 16 * 4 + 16  # all-False valid: no Eq.9 work
    ms, by = chip_smoke.bound(nb9, ops9)
    assert by == "bytes" and ms == pytest.approx(nb9 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_profile_window_on_the_cpu():
    acts = [torch.profiler.ProfilerActivity.CPU]
    res = profile_step.measure(_grid(), 32, torch.device("cpu"), acts)
    assert res["steps"] == 32 and res["lanes"] == B
    assert res["device_busy_ms_per_step"] is None  # no device activity recorded
    assert res["aten_ops_per_step"] > 100
    lab = res["labels"]
    assert lab["step"]["calls_per_step"] == 1.0
    assert lab["geo_schedule call"]["calls_per_step"] == 2.0
    assert 0.5 < lab["step"]["share_of_loop"] < 1.0
    hashes = sum(v["share_of_loop"] for k, v in lab.items() if k.startswith("hash:"))
    assert 0.0 < hashes < lab["step"]["share_of_loop"]
    # every wrapper was removed again
    assert placement.run is batch.run
    assert scheduler.plan_dispatch.__module__ == "repro_torch.core.scheduler"


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_step.py"])
def test_scripts_refuse_to_run_without_a_card(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / script)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
