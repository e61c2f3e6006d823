"""The GeoTP discrete-event engine, PyTorch port (captured lockstep lanes
and sequential map lanes, the windowed drain by default as the reference,
typed fault schedules with heartbeats and replica failover).

Entry points: `Simulator` / `Grid` / `RunResult` (`api.py`), the
single-world `simulate` (`batch.py`, the reference's `engine.simulate`),
the batched `simulate_batch` (`placement.py`) and the port's bench file:
`BENCH_DIR`, `BENCH_FILE`, `runtime_env`, `load_bench`, `record_bench`,
`record_smoke`. Every public name of the reference's `repro.core.engine` is
here: the state, lock and cause constants, the typed fault rows, the
placement table and the host-side metrics (`summarize`, `drain_stats`,
`latency_cdf`). `run` is the port's run loop: it steps the state in place
and returns (state, steps).
"""

from repro_torch.core.engine.api import (
    BENCH_DIR,
    BENCH_FILE,
    GRID_AXES,
    Grid,
    RunResult,
    Simulator,
    load_bench,
    record_bench,
    record_smoke,
    runtime_env,
)
from repro_torch.core.engine.batch import run, simulate
from repro_torch.core.engine.metrics import (
    drain_stats,
    latency_cdf,
    summarize,
    summarize_batch,
    world_index,
)
from repro_torch.core.engine.placement import (
    STRATEGIES,
    mesh_device_count,
    placement_cfg,
    resolve_strategy,
    simulate_batch,
)
from repro_torch.core.engine.state import (
    ABORT_CAUSES,
    CAUSE_ADMISSION,
    CAUSE_CRASH,
    CAUSE_EXHAUSTED,
    CAUSE_NONE,
    CAUSE_TIMEOUT,
    FAULT_COLS,
    FAULT_KINDS,
    HIST_BINS,
    INF_US,
    KIND_CRASH,
    KIND_DEGRADE,
    KIND_PARTITION,
    LK_FREE,
    LK_SHARED,
    LK_X,
    MW,
    OP_DONE,
    OP_ENROUTE,
    OP_EXEC,
    OP_HOLD,
    OP_NONE,
    OP_PENDING,
    OP_QUEUED,
    OP_WAIT,
    SUB_ABORT_ACK,
    SUB_ABORT_PEER,
    SUB_ABORTED,
    SUB_ACK,
    SUB_CHILLER_WAIT,
    SUB_COMMIT_CMD,
    SUB_DONE,
    SUB_LOCAL_COMMIT,
    SUB_NONE,
    SUB_PREP_CMD,
    SUB_PREPARING,
    SUB_ROUND_AT_DM,
    SUB_ROUND_REPLY,
    SUB_RUN,
    SUB_SCHED,
    SUB_VOTE,
    SUB_VOTED,
    SUB_WAIT_ROUND,
    T_ABORT_WAIT,
    T_ACTIVE,
    T_COMMIT_LOG,
    T_COMMIT_WAIT,
    T_IDLE,
    DynProto,
    SimConfig,
    SimState,
    WorldSpec,
    dyn_from_proto,
    init_state,
    init_state_world,
    make_world,
    pad_faults,
    stack_worlds,
)

# the names above; the submodules that importing them bound stay out
__all__ = [n for n, v in globals().items()
           if not n.startswith("_") and type(v).__name__ != "module"]
