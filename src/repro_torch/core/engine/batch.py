"""Run loops and the single-world entry point (port of
`repro.core.engine.batch`).

`run` picks the step as the reference does: the sequential lanes
(`cfg.lockstep` False, the `map` strategy and `simulate`) step each lane
on its own with `apply._drain_step` (`cfg.drain`) or `step._step`, the
lockstep lanes (`vmap`) step all lanes together with the captured
windowed or single-event step described below.

Sequential lanes. The reference's `lax.map` runs one lane after another,
each to its own end (`min(_times_flat) >= horizon_us` or `iters >=
max_events`) with no lane freeze. `run` slices each lane ([1] views of the
[B] state and bank), steps it on the host's loop (one read of the loop
condition a step, and the step's own reads of its handler id and inner
branches) and writes its final leaves back. Which kernels a step runs
depends on its event, so nothing here is captured: it is the port's slow
path on the card.

Lockstep lanes. The reference runs `jax.vmap` over a `lax.while_loop`: every lane steps
until ALL lanes' conditions are false, and a lane whose own condition is
already false keeps its old state (the vmap lane freeze). `run` does the
same on a [B]-batched state: each step computes every lane's next state
and keeps the old one where the lane is done (`min(_times_flat) >=
horizon_us` or `iters >= max_events`), on every leaf, `iters` included.

The step is the reference's lockstep step for the config: the windowed
drain `fused._omni_window` with `cfg.drain` (the default), else the
single-event `omni._omni_step`. The state's tensors are the run's static
buffers: a step (`step_into`) writes every lane's next state back into
them. On the card that step is captured once into a CUDA graph and
replayed (`CapturedStep`): either step is branchless and reads nothing on
the host, so one recording holds all of its kernels, the two
`geo_schedule` launches included, and a replay issues them without the
Python and dispatch cost of each op. This is the port's counterpart of
the reference's jit-compiled while loop (`repro.core.engine.batch`). On
the CPU the same function runs eagerly.

The worlds mesh (`placement`'s ``mesh`` row) runs several slices of one
batch through `run_slices`: a stepper a slice on the slice's device, every
slice's replays issued before the host reads any of them.

Frozen lanes are idempotent, so the host reads "all lanes done" only every
`_CHECK_EVERY` steps (one device sync per check) instead of each step; the
up to `_CHECK_EVERY - 1` steps past the end change nothing, and they are
counted in the steps `run` returns.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.core.workloads import BANK_ARRAYS, Bank, bank_to
from repro_torch.core.engine.apply import _drain_step
from repro_torch.core.engine.fused import _omni_window
from repro_torch.core.engine.metrics import summarize, to_host, world_index
from repro_torch.core.engine.omni import _omni_step
from repro_torch.core.engine.state import (
    SimConfig, SimState, _times_flat, init_state_world, make_world, stack_worlds, tree_leaves,
    tree_map,
)
from repro_torch.core.engine.step import _step
from repro_torch.kernels.geo_schedule import ops as geo_ops

# steps between two host reads of "all lanes done"; safe at any value,
# since a step leaves every frozen lane as it was
_CHECK_EVERY = 32
# real steps run before the capture: the first call builds and loads the
# kernel library and copies the histogram table to the card, neither of
# which a capture may do
_WARMUP_STEPS = 1


def lane_bank(bank: Bank, B: int, batched: bool) -> Bank:
    """A bank whose array leaves carry a leading [B] axis: per-cell banks
    as they are, a shared bank expanded (a view, no copy)."""
    if batched:
        return bank
    return bank._replace(
        **{f: getattr(bank, f).expand(B, *getattr(bank, f).shape) for f in BANK_ARRAYS}
    )


def _active(cfg: SimConfig, s: SimState) -> torch.Tensor:
    nxt = _times_flat(s).amin(1)
    return (nxt < cfg.horizon_us) & (s.iters < cfg.max_events)


def _freeze(act: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Lane b keeps `old` unless act[b]. A leaf the step did not touch (the
    same tensor object, e.g. the knobs) needs no select."""
    if new is old:
        return old
    return torch.where(act.view(-1, *([1] * (old.dim() - 1))), new, old)


def step_into(cfg: SimConfig, bank: Bank, s: SimState) -> None:
    """One lockstep step of every lane (`_omni_window` when `cfg.drain`,
    else `_omni_step`), written into `s`'s own tensors.

    Every next leaf (the step, then the lane freeze) is computed before the
    first `copy_`, so no buffer is overwritten while the step still reads
    it; a leaf the step did not touch is not copied."""
    act = _active(cfg, s)
    nxt = (_omni_window if cfg.drain else _omni_step)(cfg, bank, s)
    new = tree_map(lambda n, o: _freeze(act, n, o), nxt, s)
    for (_, n), (_, o) in zip(tree_leaves(new), tree_leaves(s)):
        if n is not o:
            o.copy_(n)


class EagerStep:
    """`step` called as it is (the CPU path)."""

    warm_steps = 0
    seconds = 0.0

    def __init__(self, step):
        self.step = step

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def join(self) -> None:
        """Nothing to wait for: the steps have run."""


class CapturedStep:
    """`step` captured once into a CUDA graph, then replayed.

    The constructor runs `step` `_WARMUP_STEPS` times for real on a side
    stream (they are steps of the run: `warm_steps`), then captures one
    call; `seconds` is the time of both. A capture records and runs
    nothing, so the `geo_schedule` launches the wrapper counted while it
    was recorded are the launches of one replay: they are taken back out of
    the count, and `replay(n)` adds n times as many. A failed capture
    raises; nothing steps eagerly in its place. The replays run on the
    stepper's own stream (the warm-up's side stream), after the work the
    current stream holds, so that several slices' graphs on one card can
    run side by side; `join` makes the current stream wait for them before
    the host reads the state. `cuda` is the module whose `Stream`,
    `current_stream`, `stream`, `CUDAGraph` and `graph` are used
    (`torch.cuda`; the CPU tests pass a stand-in)."""

    def __init__(self, step, cuda=torch.cuda):
        t0 = time.perf_counter()
        side = cuda.Stream()
        side.wait_stream(cuda.current_stream())
        with cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                step()
        cuda.current_stream().wait_stream(side)
        self.warm_steps = _WARMUP_STEPS
        self.graph = cuda.CUDAGraph()
        before = geo_ops.geo_schedule.launches
        with cuda.graph(self.graph):
            step()
        self.launches = geo_ops.geo_schedule.launches - before
        geo_ops.geo_schedule.launches = before
        self.cuda, self.stream = cuda, side
        self.seconds = time.perf_counter() - t0

    def replay(self, n: int) -> None:
        self.stream.wait_stream(self.cuda.current_stream())
        with self.cuda.stream(self.stream):
            for _ in range(n):
                self.graph.replay()
        geo_ops.geo_schedule.launches += n * self.launches

    def join(self) -> None:
        self.cuda.current_stream().wait_stream(self.stream)


def _stepper(step, s: SimState):
    """How `run` calls `step`: replayed from a CUDA graph on the card,
    eagerly on the CPU."""
    return CapturedStep(step) if s.now.device.type == "cuda" else EagerStep(step)


def _run_lane(cfg: SimConfig, bank: Bank, s: SimState):
    """Step one sequential lane (a one-lane state and bank) to its own end.
    Returns (final state, loop iterations)."""
    step = _drain_step if cfg.drain else _step
    n = 0
    while bool(_active(cfg, s)):
        s = step(cfg, bank, s)
        n += 1
    return s, n


def _run_map(cfg: SimConfig, bank: Bank, state: SimState):
    """Every lane of `state` as a sequential lane, one after another, each
    written back into `state`'s tensors. Returns (state, the lanes' loop
    iterations summed)."""
    steps = 0
    for b in range(int(state.now.shape[0])):
        lane = tree_map(lambda x: x[b:b + 1], state)
        lane_b = bank._replace(**{f: getattr(bank, f)[b:b + 1] for f in BANK_ARRAYS})
        out, n = _run_lane(cfg, lane_b, lane)
        for (_, o), (_, x) in zip(tree_leaves(lane), tree_leaves(out)):
            if x is not o:
                o.copy_(x)
        steps += n
    return state, steps


def _on(s: SimState):
    """The context a slice on `s`'s device is captured and replayed in."""
    dev = s.now.device
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def run(cfg: SimConfig, bank: Bank, state: SimState):
    """Step every lane to the horizon (or the event budget), in place.

    `bank` has [B]-leading array leaves (`lane_bank`); `state`'s tensors
    are updated in place and returned. Sequential lanes (`not
    cfg.lockstep`) return the lanes' loop iterations summed; lockstep lanes
    the lockstep steps executed, idle tail steps included. `run.capture_s`
    is the last run's warm-up and capture time (0 on the CPU and for
    sequential lanes), part of its wall time."""
    states, steps = run_slices(cfg, [bank], [state])
    return states[0], steps


def run_slices(cfg: SimConfig, banks: list, states: list):
    """`run` over several slices of one batch (the worlds mesh's, one a
    device), each stepped in place on its own device; returns (states,
    steps summed over the slices).

    Lockstep slices get a stepper each (a `CapturedStep` recorded under
    the slice's device, replaying on its own stream there), and every
    slice's `replay(n)` is issued before any slice is joined and the host
    reads its "all lanes done": a read waits for its device, so reading
    between the issues would run the slices one after another (on one card
    the slices' streams also run side by side). A slice stops on its own
    check, so each takes the steps it would take alone; one slice is
    `run`'s loop as it is. `run.slice_capture_s` holds each stepped
    slice's warm-up and capture seconds, `run.capture_s` their sum."""
    run.capture_s, run.slice_capture_s = 0.0, []
    if not cfg.lockstep:
        steps = 0
        for bank, s in zip(banks, states):
            steps += _run_map(cfg, bank, s)[1]
        return states, steps
    live, steps = [], 0
    for bank, s in zip(banks, states):
        if not bool(_active(cfg, s).any()):
            continue
        with _on(s):
            stepper = _stepper(functools.partial(step_into, cfg, bank, s), s)
        run.slice_capture_s.append(stepper.seconds)
        steps += stepper.warm_steps
        live.append((stepper, s))
    run.capture_s = sum(run.slice_capture_s)
    # the first check after _CHECK_EVERY steps, as on the CPU
    n = _CHECK_EVERY - (live[0][0].warm_steps if live else 0)
    while live:
        for stepper, s in live:
            with _on(s):
                stepper.replay(n)
            steps += n
        for stepper, s in live:
            with _on(s):
                stepper.join()
        live = [(stepper, s) for stepper, s in live if bool(_active(cfg, s).any())]
        n = _CHECK_EVERY
    return states, steps


run.capture_s, run.slice_capture_s = 0.0, []


def simulate(cfg: SimConfig, bank: Bank, tau_true_us, tau_ds_us, jitter_milli: int = 0,
             exec_scale_milli=None, state: SimState | None = None, faults=None,
             replica_tau=None, repl_lag_us: int = 0, device=None):
    """Single-world convenience entry (the reference's `engine.simulate`):
    init (or continue `state`) + run + summarize, on `device` (None means
    the card). The world takes its knobs from `cfg.proto`; `faults` is a
    [cfg.max_faults, 6] typed schedule (legacy crash triples are widened,
    see `state.pad_faults`) and, with `replica_tau` ([D], INF_US = no
    replica) and `repl_lag_us`, only meaningful on fresh runs of a
    fault-carrying config. The default `SimConfig` (lockstep False) steps
    the sequential lane. A continued `state` (a one-lane state this
    function returned) must lie on `device`, and is stepped in place.

    Returns (final one-lane state, its metric dict)."""
    dev = resolve_device(device)
    if state is None:
        world = make_world(
            cfg.proto, tau_true_us=tau_true_us, tau_ds_us=tau_ds_us,
            jitter_milli=jitter_milli, exec_scale_milli=exec_scale_milli, faults=faults,
            max_faults=cfg.max_faults, replica_tau=replica_tau, repl_lag_us=repl_lag_us,
        )
        state = init_state_world(cfg, stack_worlds([world]), dev)
    elif state.now.device.type != dev.type:
        raise ValueError(f"state lies on {state.now.device}, but the run is on {dev}")
    state, _ = run(cfg, lane_bank(bank_to(bank, dev), 1, False), state)
    return state, summarize(cfg, world_index(to_host(state), 0))
