"""The engine's run loop as a static-buffer step (`batch.step_into`): every
step writes the lanes' next state back into the state's own tensors, the
function a CUDA graph captures on the card (`batch.CapturedStep`).

Here on the CPU: the in-place run of the single-event step (`drain=False`)
is bitwise the reference on every final `SimState` leaf, with lanes that
finish at different steps (so the lane freeze and the copy-back both act)
on a shared bank and on per-cell banks; every buffer keeps its storage
across steps; and the runner's launch
accounting (launches counted while the step is captured, times the
replays) gives two `geo_schedule` launches a step, for the single-event
and the windowed step, with a stand-in for the CUDA graph that records a
step and replays it eagerly."""

import contextlib

import jax
import numpy as np
import pytest

from repro.core import engine as r_engine
from repro.core import workloads as r_wl
from repro_torch.core import workloads as t_wl
from repro_torch.core.engine import Grid, Simulator, batch
from repro_torch.core.engine.state import tree_leaves
from repro_torch.kernels.geo_schedule import ops as geo_ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, K, D, N = 4, 5, 4, 16
HORIZON_S, WARMUP_S = 0.3, 0.05
CELL_PRESETS = ("ssp", "ssp-local", "scalardb", "geotp", "fastc", "opta")


def _banks(seed):
    kw = dict(num_ds=D, records_per_node=2000, ops_per_txn=K, dist_ratio=0.5, theta=0.9,
              seed=seed)
    return (r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), T, N),
            t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), T, N))


def _grids(per_cell):
    """(reference grid, port grid, reference bank, port bank): six presets
    on one shared bank, or three seeds x two presets with a bank each."""
    if not per_cell:
        rb, tb = _banks(0)
        cells = [dict(preset=p) for p in CELL_PRESETS]
        return r_engine.Grid(cells), Grid(cells), rb, tb
    pairs = {sd: _banks(sd) for sd in (0, 1, 2)}
    cells = [dict(preset=p, seed=sd) for sd in pairs for p in ("ssp", "geotp")]
    return (r_engine.Grid(cells, banks=[pairs[c["seed"]][0] for c in cells]),
            Grid(cells, banks=[pairs[c["seed"]][1] for c in cells]), None, None)


def _port_sim(bank, drain=False):
    return Simulator.from_bank(bank, horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=drain,
                               track_slots=True, device="cpu")


def _assert_states_equal(port_states, ref_states):
    ref = jax.tree_util.tree_map(np.asarray, ref_states)
    for name, x in tree_leaves(port_states):
        r = ref
        for part in name.split("."):
            r = getattr(r, part)
        got = x.numpy()
        assert got.dtype == r.dtype and got.shape == r.shape, name
        if not np.array_equal(got, r):
            lanes = [b for b in range(got.shape[0]) if not np.array_equal(got[b], r[b])]
            pytest.fail(f"leaf {name} differs in lanes {lanes}")


@pytest.mark.parametrize("per_cell", [False, True], ids=["shared_bank", "per_cell_banks"])
def test_static_buffer_run_matches_reference(per_cell, monkeypatch):
    rg, tg, rb, tb = _grids(per_cell)
    ptrs, real = [], batch.step_into

    def step_into(cfg, bank, s):
        ptrs.append([x.data_ptr() for _, x in tree_leaves(s)])
        real(cfg, bank, s)

    monkeypatch.setattr(batch, "step_into", step_into)
    tres = _port_sim(tb if tb is not None else tg.banks[0]).run_grid(tg, tb, strategy="vmap")
    rsim = r_engine.Simulator.from_bank(rb if rb is not None else rg.banks[0],
                                        horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=False,
                                        track_slots=True)
    _assert_states_equal(tres.states, rsim.run_grid(rg, rb, strategy="map").states)
    assert len(ptrs) == tres.steps and tres.steps % batch._CHECK_EVERY == 0
    final = [x.data_ptr() for _, x in tree_leaves(tres.states)]
    assert all(p == final for p in ptrs), "a static buffer changed its storage"
    # lanes finished at different steps: the freeze held the early ones
    iters = tres.states.iters.tolist()
    assert len(set(iters)) > 1 and tres.steps > max(iters)


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A recorded step: `replay` runs it, and, as a replay runs no Python,
    the wrapper's count does not move."""

    def __init__(self, step):
        self.step, self.replays = step, 0

    def replay(self):
        self.replays += 1
        n = geo_ops.geo_schedule.launches
        self.step()
        geo_ops.geo_schedule.launches = n


class _FakeCuda:
    """The parts of `torch.cuda` that `CapturedStep` calls, on the CPU. A
    capture calls the step eagerly (ops run here, where on a card they are
    recorded) and then puts every state leaf back as it was: a real capture
    changes no buffer. A replay runs the step."""

    def __init__(self, step, state):
        self.step, self.state, self.graphs = step, state, []

    Stream = _Stream

    def current_stream(self):
        return _Stream()

    def stream(self, s):
        return contextlib.nullcontext()

    def CUDAGraph(self):  # noqa: N802 (torch.cuda's name)
        self.graphs.append(_Graph(self.step))
        return self.graphs[-1]

    @contextlib.contextmanager
    def graph(self, g):
        saved = [x.clone() for _, x in tree_leaves(self.state)]
        yield
        for (_, x), y in zip(tree_leaves(self.state), saved):
            x.copy_(y)


def test_launch_accounting_with_a_stand_in_graph(monkeypatch):
    """Replays x the launches counted during the capture, plus the warm-up
    step's own, equal 2 launches a step; the state and steps are the eager
    run's."""
    _check_launch_accounting(False, monkeypatch)


def test_launch_accounting_of_the_windowed_step_with_a_stand_in_graph(monkeypatch):
    """The same for the windowed step (`fused._omni_window`, `drain=True`)."""
    _check_launch_accounting(True, monkeypatch)


def _check_launch_accounting(drain, monkeypatch):
    _, tg, _, tb = _grids(False)
    eager = _port_sim(tb, drain).run_grid(tg, tb, strategy="vmap")

    real = geo_ops.geo_schedule

    def counting(*args):  # the CUDA wrapper's count, on CPU tensors
        counting.launches += 1
        return real(*args)

    counting.launches = 0
    monkeypatch.setattr(geo_ops, "geo_schedule", counting)
    made = []

    def stepper(step, s):
        made.append(batch.CapturedStep(step, cuda=_FakeCuda(step, s)))
        return made[-1]

    monkeypatch.setattr(batch, "_stepper", stepper)
    res = _port_sim(tb, drain).run_grid(tg, tb, strategy="vmap")
    (cap,) = made
    graph = cap.graph
    assert cap.warm_steps == batch._WARMUP_STEPS and cap.launches == 2
    assert graph.replays == res.steps - cap.warm_steps
    assert counting.launches == graph.replays * cap.launches + 2 * cap.warm_steps
    assert counting.launches == 2 * res.steps
    assert res.steps == eager.steps and res.cfg.drain == drain
    for (name, x), (_, y) in zip(tree_leaves(res.states), tree_leaves(eager.states)):
        assert x.dtype == y.dtype and bool((x == y).all()), name
