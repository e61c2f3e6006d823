"""The PyTorch port stands alone: no JAX, nothing of `repro` or of the
reference's `benchmarks`, CUDA by default, and loud about what it has not
ported yet."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.core import workloads
from repro_torch.core.engine import Grid, Simulator, apply, window
from repro_torch.core.engine.batch import lane_bank
from repro_torch.core.engine.state import init_state_world, stack_worlds

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro', "
        "'benchmarks'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().split(" ", 1)
    assert int(n_mods) >= len(SLICE_MODULES) + 30  # every submodule was imported
    assert bad == "[]", bad


# the modules of slices 2 and 3 (the serving path of the LM stack: the
# dense GQA family, then the recurrent mixers), slice 9's windowed drain and
# slice 10's fault injection, slice 11's bench harness, slice 12's
# sequential lanes and slice 13's figures, claims, examples and shims,
# beside slice 1's
SLICE_MODULES = [
    "unported.py",
    "configs/registry.py",
    "models/config.py",
    "models/schema.py",
    "models/layers.py",
    "models/attention.py",
    "models/stack.py",
    "models/model.py",
    "kernels/decode_attention/decode_attention.py",
    "kernels/decode_attention/ops.py",
    "kernels/decode_attention/ref.py",
    "kernels/flash_attention/flash_attention.py",
    "kernels/flash_attention/ops.py",
    "kernels/flash_attention/ref.py",
    "serving/kvcache.py",
    "serving/engine.py",
    "launch/serve.py",
    "models/xlstm.py",
    "models/rglru.py",
    "kernels/mlstm/mlstm.py",
    "kernels/mlstm/ops.py",
    "kernels/mlstm/ref.py",
    "kernels/rglru/rglru.py",
    "kernels/rglru/ops.py",
    "kernels/rglru/ref.py",
    "core/engine/chain.py",
    "core/engine/window.py",
    "core/engine/apply.py",
    "core/engine/fused.py",
    "core/engine/faults.py",
    "core/engine/step.py",
    "core/engine/handlers.py",
    "core/engine/locks.py",
    "bench/common.py",
    "bench/smoke.py",
    "bench/claims.py",
    "bench/figures.py",
    "bench/run.py",
    "examples/quickstart.py",
    "examples/simulate_paper.py",
    "examples/serve_geo.py",
    "core/protocol.py",
]


def test_sources_import_no_jax_and_no_repro():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro|benchmarks)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert {PKG / m for m in SLICE_MODULES} <= set(files)
    files += [ROOT / "chip_smoke.py", ROOT / "profile_step.py"]
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_engine_modules_stay_under_900_lines():
    """The reference's layering guard, held by the port's engine too."""
    for f in sorted((PKG / "core" / "engine").glob("*.py")):
        assert len(f.read_text().splitlines()) <= 900, f.name


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator(2, 2, 2, 4)
    Simulator(2, 2, 2, 4, device="cpu")  # explicit CPU is fine


def _bank():
    cfg = workloads.YCSBConfig(num_ds=2, records_per_node=64, ops_per_txn=2)
    return workloads.make_ycsb_bank(cfg, terminals=2, txns_per_terminal=4)


@pytest.mark.parametrize(
    "case",
    ["drain", "map", "mesh", "resume-map", "resume-mesh"],
)
def test_unported_paths_raise_not_implemented(case):
    """`mesh` (and `resume`'s mesh placement) raise A7. The sequential
    lanes run: `_drain_step` and its window plan,
    `run_grid(strategy="map")` and `resume(strategy="map")`."""
    bank = _bank()
    grid = Grid.cross(preset=("ssp",), rtt_ms=(0.0, 10.0))
    sim = Simulator.from_bank(bank, horizon_s=0.05, warmup_s=0.0, device="cpu")
    if case == "drain":
        # the sequential lanes' drain step on a fresh one-lane state, and its
        # window plan (the sequential config: lockstep False)
        cfg = sim.cfg
        assert cfg.drain and not cfg.lockstep
        s = init_state_world(cfg, stack_worlds([grid.world(0)]))
        lb = lane_bank(bank, 1, False)
        plan = window._window_plan(cfg, lb, s)
        assert plan.pos_term.shape == (1, cfg.terminals)
        nxt = apply._drain_step(cfg, lb, s)
        assert int(nxt.iters[0]) >= 1 and int(nxt.noops[0]) == 0
        return
    if case in ("map", "mesh"):
        if case == "mesh":
            with pytest.raises(NotImplementedError, match="ROADMAP.md §A item A7"):
                sim.run_grid(grid, bank, strategy=case)
            return
        res = sim.run_grid(grid, bank, strategy="map")
        assert res.strategy_resolved == "map" and not res.cfg.lockstep
        assert all(m["noops"] == 0 for m in res.metrics) and res.events > 0
        return
    # resume and save are ported; resume's mesh placement is not
    res = sim.run_grid(grid, bank)
    assert res.strategy_resolved == "vmap" and res.metrics[0]["noops"] == 0 and res.cfg.drain
    if case == "resume-map":
        events = res.events
        res = sim.resume(res, horizon_s=0.1, strategy="map")
        assert res.strategy_resolved == "map" and not res.cfg.lockstep
        assert res.events > events and res.metrics[0]["noops"] == 0
        return
    for kw in (dict(strategy="mesh"), dict(mesh_devices=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §A item A7"):
            sim.resume(res, horizon_s=0.1, **kw)


def test_grid_validation_messages():
    with pytest.raises(ValueError, match=r"Grid cell 1: unknown preset 'nope'"):
        Grid([{"preset": "ssp"}, {"preset": "nope"}])
    with pytest.raises(ValueError, match="missing required key 'preset'"):
        Grid([{}])
    with pytest.raises(ValueError, match="differs from cell 0's num_ds"):
        Grid([{"preset": "ssp", "rtt_ms": (0.0, 1.0)}, {"preset": "ssp"}])
    with pytest.raises(ValueError, match="clock_skew_us must be a non-negative"):
        Grid([{"preset": "tiga", "clock_skew_us": -1}])
    with pytest.raises(ValueError, match="unknown strategy"):
        Simulator(2, 2, 2, 4, device="cpu").run_grid(
            Grid.cross(preset="ssp", rtt_ms=(0.0, 1.0)), _bank(), strategy="nope"
        )
