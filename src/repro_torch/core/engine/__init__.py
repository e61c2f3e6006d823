"""The GeoTP discrete-event engine, PyTorch port (lockstep lanes, the
windowed drain by default as the reference, typed fault schedules with
heartbeats and replica failover).

Entry points: `Simulator` / `Grid` / `RunResult` (`api.py`).
"""

from repro_torch.core.engine.api import Grid, RunResult, Simulator
from repro_torch.core.engine.state import (
    SimConfig,
    SimState,
    WorldSpec,
    init_state,
    init_state_world,
    make_world,
    stack_worlds,
)

__all__ = [
    "Grid",
    "RunResult",
    "Simulator",
    "SimConfig",
    "SimState",
    "WorldSpec",
    "init_state",
    "init_state_world",
    "make_world",
    "stack_worlds",
]
