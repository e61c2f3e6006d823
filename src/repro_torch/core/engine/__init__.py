"""The GeoTP discrete-event engine, PyTorch port (captured lockstep lanes
and sequential map lanes, the windowed drain by default as the reference,
typed fault schedules with heartbeats and replica failover).

Entry points: `Simulator` / `Grid` / `RunResult` (`api.py`), the
single-world `simulate` (`batch.py`, the reference's `engine.simulate`),
and the port's bench file: `BENCH_FILE`, `runtime_env`, `load_bench`,
`record_bench`, `record_smoke`.
"""

from repro_torch.core.engine.api import (
    BENCH_FILE,
    Grid,
    RunResult,
    Simulator,
    load_bench,
    record_bench,
    record_smoke,
    runtime_env,
)
from repro_torch.core.engine.batch import simulate
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
    "BENCH_FILE",
    "Grid",
    "RunResult",
    "Simulator",
    "SimConfig",
    "SimState",
    "WorldSpec",
    "init_state",
    "init_state_world",
    "load_bench",
    "make_world",
    "record_bench",
    "record_smoke",
    "runtime_env",
    "simulate",
    "stack_worlds",
]
