"""The port's fault injection on the CPU, (b) of `test_torch_faults.py`:
an all-pad (INF_US) schedule against the fault-free run, all 12 presets,
every leaf equal but the schedule's own leaves. In a file of its own so
that pytest-xdist (`--dist loadfile`) can run it beside the rest.
"""

import functools

import torch

from repro_torch.core.engine import Grid, Simulator
from repro_torch.core.engine.state import INF_US, tree_leaves
from repro_torch.core.protocols import PRESETS
from test_torch_engine import _rows_equal
from test_torch_faults import RTT, _banks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def _pad_pair():
    tbank = _banks()[1]
    sim = Simulator.from_bank(tbank, horizon_s=0.5, warmup_s=0.0, track_slots=True, device="cpu")
    presets = tuple(sorted(PRESETS))
    clean = sim.run_grid(Grid.cross(preset=presets, rtt_ms=RTT), tbank, strategy="vmap")
    pad = ((INF_US, 0, INF_US),) * 3
    padded = sim.run_grid(Grid.cross(preset=presets, rtt_ms=RTT, faults=(pad,)), tbank,
                          strategy="vmap")
    return clean, padded


SCHEDULE_LEAVES = ("fault_ds", "fault_recover", "fault_time", "fault_stage", "fault_kind",
                   "fault_peer", "fault_sev")


def test_pad_schedule_matches_the_fault_free_run():
    """The reference's `test_inf_schedule_matches_fault_free_engine`, all 12
    presets as one grid: the tail sections never fire and perturb nothing."""
    clean, padded = _pad_pair()
    assert clean.cfg.max_faults == 0 and padded.cfg.max_faults == 3
    assert clean.states.fault_time.shape == (12, 0)
    for (name, x), (_, y) in zip(tree_leaves(padded.states), tree_leaves(clean.states)):
        if name not in SCHEDULE_LEAVES:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    _rows_equal(padded.rows(), clean.rows())
    assert not padded.states.ds_down.any() and int(padded.states.hb_count.sum()) == 0
    assert padded.drain["availability"] == 1.0
