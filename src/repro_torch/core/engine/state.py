"""Static shapes, state containers and shared scalar helpers (port of
`repro.core.engine.state`).

The port's engine is lockstep-only: every `SimState` leaf carries a leading
[B] lane axis (a scalar of the reference is [B] here, a [T,K] array is
[B,T,K]), and the helpers below take such batched states. Leaf names,
order and dtypes are the reference's, so states compare leaf by leaf
(`repro_torch.interop`). Fault schedules are [F, 6] typed rows
(`KIND_CRASH` / `KIND_PARTITION` / `KIND_DEGRADE`), F = `SimConfig.max_faults`;
F = 0 is the fault-free engine, whose helpers and event-time view carry no
link state and no fault / heartbeat tail.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core.netmodel import (
    INF_US,
    PAPER_RTT_MS,
    _hash_u32,
    derive_tau_ds_us,
    make_net_params,
)
from repro_torch.core.protocols import (
    PRESETS,
    PREPARE_DECENTRAL,
    STAGGER_NONE,
    ProtocolConfig,
)
# ---- op states -------------------------------------------------------------
OP_NONE, OP_PENDING, OP_ENROUTE, OP_QUEUED, OP_WAIT, OP_EXEC, OP_HOLD, OP_DONE = range(8)

# ---- subtxn states ---------------------------------------------------------
(
    SUB_NONE,
    SUB_SCHED,
    SUB_RUN,
    SUB_ROUND_REPLY,
    SUB_ROUND_AT_DM,
    SUB_WAIT_ROUND,
    SUB_CHILLER_WAIT,
    SUB_PREP_CMD,
    SUB_PREPARING,
    SUB_VOTE,
    SUB_VOTED,
    SUB_COMMIT_CMD,
    SUB_ACK,
    SUB_LOCAL_COMMIT,
    SUB_DONE,
    SUB_ABORT_PEER,
    SUB_ABORT_ACK,
    SUB_ABORTED,
) = range(18)

# ---- terminal phases -------------------------------------------------------
T_IDLE, T_ACTIVE, T_COMMIT_LOG, T_COMMIT_WAIT, T_ABORT_WAIT = range(5)

# ---- lock modes ------------------------------------------------------------
LK_FREE, LK_SHARED, LK_X = 0, 1, 2

HIST_BINS = 128
_HIST_BASE_US = 100.0  # bin 0 at 100 µs, 8 bins per octave

# int32 value of the reference's salt multiplier
_SALT_MUL = 2654435761 % (2**31)

# windowed-drain stop reasons (the `win_stops` telemetry leaf)
STOP_REASONS = (
    "horizon", "nondrainable", "scheduled", "lock_key", "dm_row",
    "dm_col", "rel_op", "cap", "fault", "sched_chain",
)
N_STOP_REASONS = len(STOP_REASONS)

(
    CAUSE_NONE,
    CAUSE_TIMEOUT,
    CAUSE_ADMISSION,
    CAUSE_CRASH,
    CAUSE_EXHAUSTED,
) = range(5)
N_ABORT_CAUSES = 5
ABORT_CAUSES = ("none", "timeout", "admission", "crash", "exhausted")

FAULT_COLS = 6

# Typed fault rows: (t_start_us, kind, endpoint_a, endpoint_b, t_end_us,
# severity), the reference's table (`repro.core.engine.state`):
#   CRASH      data source endpoint_a (== endpoint_b) down; severity unused.
#   PARTITION  endpoint_a == MW: the middleware<->endpoint_b link severed;
#              endpoint_a >= 0: the mesh link a<->b severed (both ways).
#   DEGRADE    the link's RTT times severity/1000 between start and end.
KIND_CRASH, KIND_PARTITION, KIND_DEGRADE = 0, 1, 2
FAULT_KINDS = ("crash", "partition", "degrade")
MW = -1  # endpoint_a value selecting the middleware side of a link
_PAD_ROW = (INF_US, KIND_CRASH, 0, 0, INF_US, 0)


class DynProto(NamedTuple):
    """Dynamic protocol knobs, one tensor per `ProtocolConfig` field the
    step consults ([B] once worlds are stacked)."""

    prepare: torch.Tensor  # i32
    stagger: torch.Tensor  # i32
    admission: torch.Tensor  # bool
    early_abort: torch.Tensor  # bool
    chiller_two_stage: torch.Tensor  # bool
    middleware_cc: torch.Tensor  # bool
    async_local_commit: torch.Tensor  # bool
    co_commit: torch.Tensor  # bool
    opt_abort: torch.Tensor  # bool
    tiga_slack_us: torch.Tensor  # i32
    max_blocked: torch.Tensor  # i32
    admission_backoff_us: torch.Tensor  # i32
    block_prob_cap: torch.Tensor  # f32
    lock_timeout_us: torch.Tensor  # i32
    exec_us: torch.Tensor  # i32
    log_flush_us: torch.Tensor  # i32
    lan_rtt_us: torch.Tensor  # i32
    retry_backoff_us: torch.Tensor  # i32
    max_retries: torch.Tensor  # i32
    hb_interval_us: torch.Tensor  # i32
    detect_delay_us: torch.Tensor  # i32


def dyn_from_proto(p: ProtocolConfig) -> DynProto:
    """The preset's knobs as 0-d CPU tensors, with the reference's checks."""
    if p.max_retries > 0 and p.retry_backoff_us <= 0:
        raise ValueError(
            f"preset {p.name!r}: max_retries={p.max_retries} needs "
            f"retry_backoff_us > 0 (got {p.retry_backoff_us})"
        )
    if p.detect_delay_us < 0:
        raise ValueError(
            f"preset {p.name!r}: detect_delay_us must be >= 0 "
            f"(got {p.detect_delay_us})"
        )
    if p.co_commit and (p.prepare != PREPARE_DECENTRAL or p.chiller_two_stage):
        raise ValueError(
            f"preset {p.name!r}: co_commit requires PREPARE_DECENTRAL "
            f"without chiller_two_stage"
        )
    if p.tiga_slack_us < 0:
        raise ValueError(
            f"preset {p.name!r}: tiga_slack_us must be >= 0 (got {p.tiga_slack_us})"
        )
    if p.tiga_slack_us > 0 and (
        p.prepare != PREPARE_DECENTRAL
        or p.stagger != STAGGER_NONE
        or p.chiller_two_stage
        or p.co_commit
    ):
        raise ValueError(
            f"preset {p.name!r}: tiga_slack_us > 0 requires PREPARE_DECENTRAL "
            f"+ STAGGER_NONE without chiller_two_stage/co_commit"
        )
    fields = {}
    for f in DynProto._fields:
        v = getattr(p, f)
        if isinstance(v, bool):
            fields[f] = torch.tensor(v)
        elif f == "block_prob_cap":
            fields[f] = torch.tensor(v, dtype=torch.float32)
        else:
            fields[f] = torch.tensor(v, dtype=torch.int32)
    return DynProto(**fields)


class WorldSpec(NamedTuple):
    """One cell of an evaluation grid ([B]-stacked by `stack_worlds`)."""

    tau_true: torch.Tensor  # [D] DM<->DS RTT µs
    tau_ds: torch.Tensor  # [D,D] geo-agent mesh RTT µs
    jitter_milli: torch.Tensor
    exec_scale_milli: torch.Tensor  # [D]
    lel_scale_milli: torch.Tensor
    dyn: DynProto
    seed: torch.Tensor
    faults: torch.Tensor  # [F, 6] typed rows, padded with _PAD_ROW
    replica_tau: torch.Tensor  # [D], INF_US = no replica
    repl_lag_us: torch.Tensor
    clock_skew_us: torch.Tensor


def _widen_faults(rows: torch.Tensor) -> torch.Tensor:
    """[n, 3] legacy crash triples -> [n, 6] typed rows (no-op on [n, 6])."""
    if rows.shape[-1] == FAULT_COLS:
        return rows
    if rows.shape[-1] != 3:
        raise ValueError(
            f"fault rows must have 3 (legacy crash) or {FAULT_COLS} columns, "
            f"got {rows.shape[-1]}"
        )
    t, ds, rec = rows[:, 0], rows[:, 1], rows[:, 2]
    kind = torch.full_like(t, KIND_CRASH)
    return torch.stack([t, kind, ds, ds, rec, torch.zeros_like(t)], dim=1)


def pad_faults(faults, max_faults: int | None = None) -> torch.Tensor:
    """A fault schedule as a static [F, 6] int32 tensor: typed rows or
    legacy (t_crash_us, ds, t_recover_us) triples (widened), None for no
    faults; padded to `max_faults` rows with `_PAD_ROW` (t_start INF_US
    never fires inside the horizon)."""
    if faults is None:
        rows = torch.zeros((0, FAULT_COLS), dtype=torch.int32)
    else:
        rows = torch.as_tensor(faults, dtype=torch.int32)
        if rows.dim() != 2:
            cols = FAULT_COLS if rows.numel() % FAULT_COLS == 0 else 3
            rows = rows.reshape(-1, cols)
        rows = _widen_faults(rows)
    n = rows.shape[0]
    if max_faults is None:
        max_faults = n
    if n > max_faults:
        raise ValueError(f"{n} fault rows exceed max_faults={max_faults}")
    pad = torch.tensor([_PAD_ROW], dtype=torch.int32).repeat(max_faults - n, 1)
    return torch.cat([rows, pad], 0)


def make_world(
    proto,
    rtt_ms=None,
    *,
    tau_true_us=None,
    tau_ds_us=None,
    jitter_milli: int = 0,
    exec_scale_milli=None,
    seed: int = 0,
    faults=None,
    max_faults: int | None = None,
    replica_tau=None,
    repl_lag_us: int = 0,
    clock_skew_us: int = 0,
) -> WorldSpec:
    """A WorldSpec from a preset name / ProtocolConfig + RTTs. `replica_tau`
    is the optional [D] middleware<->replica RTT (INF_US, or None, = no
    replica), `repl_lag_us` the lag charged to each stale read."""
    if isinstance(proto, str):
        proto = PRESETS[proto]
    if tau_true_us is None:
        tau_true_us = make_net_params(rtt_ms if rtt_ms is not None else PAPER_RTT_MS).tau_dm
    tau_true = torch.as_tensor(tau_true_us, dtype=torch.int32)
    if tau_ds_us is None:
        tau_ds_us = derive_tau_ds_us(tau_true)
    if exec_scale_milli is None:
        exec_scale_milli = torch.full(tau_true.shape, 1000, dtype=torch.int32)
    if replica_tau is None:
        replica_tau = torch.full(tau_true.shape, INF_US, dtype=torch.int32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return WorldSpec(
        tau_true=tau_true,
        tau_ds=torch.as_tensor(tau_ds_us, dtype=torch.int32),
        jitter_milli=i32(jitter_milli),
        exec_scale_milli=torch.as_tensor(exec_scale_milli, dtype=torch.int32),
        lel_scale_milli=i32(proto.lel_scale_milli),
        dyn=dyn_from_proto(proto),
        seed=i32(seed),
        faults=pad_faults(faults, max_faults),
        replica_tau=torch.as_tensor(replica_tau, dtype=torch.int32),
        repl_lag_us=i32(repl_lag_us),
        clock_skew_us=i32(clock_skew_us),
    )


def tree_map(fn, *trees):
    """Map `fn` over the tensor leaves of (nested) NamedTuples."""
    t0 = trees[0]
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def tree_leaves(tree, prefix: str = ""):
    """[(dotted name, tensor)] over (nested) NamedTuples, in field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f, v in zip(tree._fields, tree):
            out += tree_leaves(v, f"{prefix}{f}.")
        return out
    return [(prefix[:-1], tree)]


def stack_worlds(worlds) -> WorldSpec:
    """[W_1..W_B] -> WorldSpec with a leading [B] axis on every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *worlds)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static engine configuration (shapes + defaults); the reference's
    fields. `proto` only provides defaults (`compare=False`)."""

    terminals: int
    max_ops: int
    num_ds: int
    bank_txns: int
    proto: ProtocolConfig = dataclasses.field(compare=False)
    hot_capacity: int = 1024
    warmup_us: int = 2_000_000
    horizon_us: int = 12_000_000
    max_events: int = 4_000_000
    alpha_milli: int = 800  # Eq.(4) EWMA α
    beta_milli: int = 875  # network-latency EWMA
    drain: bool = True  # windowed drain (`fused._omni_window`), as the reference
    lockstep: bool = False
    track_slots: bool = False
    max_faults: int = 0


class SimState(NamedTuple):
    now: torch.Tensor
    iters: torch.Tensor
    phase: torch.Tensor  # [T] i8
    cur: torch.Tensor
    txn_ctr: torch.Tensor
    retries: torch.Tensor
    blocked: torch.Tensor
    retry_same: torch.Tensor
    term_time: torch.Tensor
    arrive: torch.Tensor
    is_dist: torch.Tensor
    cur_round: torch.Tensor  # [T] i8
    op_state: torch.Tensor  # [T,K] i8
    op_key: torch.Tensor
    op_write: torch.Tensor
    op_ds: torch.Tensor  # [T,K] i8
    op_round: torch.Tensor  # [T,K] i8
    op_time: torch.Tensor
    op_enq: torch.Tensor
    inv: torch.Tensor
    sub_state: torch.Tensor  # [T,D] i8
    sub_time: torch.Tensor
    sub_arrive: torch.Tensor
    sub_lel: torch.Tensor
    first_lock: torch.Tensor
    rd_done: torch.Tensor
    sub_fast: torch.Tensor
    fault_ds: torch.Tensor  # [F]
    fault_recover: torch.Tensor
    fault_time: torch.Tensor
    fault_stage: torch.Tensor  # [F] i8
    fault_kind: torch.Tensor
    fault_peer: torch.Tensor
    fault_sev: torch.Tensor
    ds_down: torch.Tensor  # [D] bool
    mw_heal: torch.Tensor
    ds_heal: torch.Tensor
    tau_mw_eff: torch.Tensor
    tau_ds_eff: torch.Tensor
    repl_tau: torch.Tensor
    repl_lag_us: torch.Tensor
    on_repl: torch.Tensor
    stale_reads: torch.Tensor
    failovers: torch.Tensor
    max_stale_us: torch.Tensor
    hb_time: torch.Tensor
    hb_count: torch.Tensor
    down_since: torch.Tensor
    down_us: torch.Tensor
    abort_cause: torch.Tensor
    ab_cause: torch.Tensor
    commits_fault: torch.Tensor
    hs: hs_mod.HashHotspot
    tau_true: torch.Tensor
    tau_est: torch.Tensor
    tau_ds: torch.Tensor
    jitter_milli: torch.Tensor
    exec_scale_milli: torch.Tensor
    lel_scale_milli: torch.Tensor
    clock_skew_us: torch.Tensor
    commits: torch.Tensor
    aborts: torch.Tensor
    commits_dist: torch.Tensor
    aborts_dist: torch.Tensor
    lat_sum: torch.Tensor
    lat_sum_dist: torch.Tensor
    hist_all: torch.Tensor
    hist_cen: torch.Tensor
    hist_dist: torch.Tensor
    lcs_sum: torch.Tensor
    lcs_cnt: torch.Tensor
    wan_legs: torch.Tensor
    fast_commits: torch.Tensor
    noops: torch.Tensor
    drained: torch.Tensor
    windows: torch.Tensor
    win_stops: torch.Tensor
    fused: torch.Tensor
    chained: torch.Tensor
    slot_commits: torch.Tensor  # [T, N or 1]
    slot_aborts: torch.Tensor
    slot_lat: torch.Tensor
    dyn: DynProto


def init_state(cfg: SimConfig, world: WorldSpec) -> SimState:
    """Initial state of ONE (unbatched, CPU) world; `world.faults` has
    `cfg.max_faults` rows."""
    T, K, D, N, F = cfg.terminals, cfg.max_ops, cfg.num_ds, cfg.bank_txns, cfg.max_faults
    i32 = torch.int32
    z = lambda shape, dt=i32: torch.zeros(shape, dtype=dt)  # noqa: E731
    full = lambda shape, v: torch.full(shape, v, dtype=i32)  # noqa: E731
    s0 = lambda: torch.tensor(0, dtype=i32)  # noqa: E731
    faults = world.faults.to(i32).reshape(F, FAULT_COLS)
    # failure detection lag: crash / partition starts fire detect_delay_us
    # late; degrades shift nothing, and end times are never shifted
    f_start, f_kind = faults[:, 0], faults[:, 1]
    detect = torch.where(f_kind == KIND_DEGRADE, 0, world.dyn.detect_delay_us)
    f_first = torch.where(f_start < INF_US, f_start + detect, f_start).to(i32)
    start = ((torch.arange(T, dtype=i32) * 2000) // max(T, 1)).to(i32)
    nslot = N if cfg.track_slots else 1
    return SimState(
        now=s0(), iters=s0(),
        phase=z((T,), torch.int8), cur=z((T,)), txn_ctr=z((T,)), retries=z((T,)),
        blocked=z((T,)), retry_same=z((T,), torch.bool), term_time=start,
        arrive=z((T,)), is_dist=z((T,), torch.bool), cur_round=z((T,), torch.int8),
        op_state=z((T, K), torch.int8), op_key=z((T, K)), op_write=z((T, K), torch.bool),
        op_ds=z((T, K), torch.int8), op_round=z((T, K), torch.int8),
        op_time=full((T, K), INF_US), op_enq=z((T, K)),
        inv=z((T, D), torch.bool), sub_state=z((T, D), torch.int8),
        sub_time=full((T, D), INF_US), sub_arrive=z((T, D)), sub_lel=z((T, D)),
        first_lock=full((T, D), INF_US), rd_done=z((T, D), torch.bool),
        sub_fast=z((T, D), torch.bool),
        fault_ds=faults[:, 2].clone(), fault_recover=faults[:, 4].clone(), fault_time=f_first,
        fault_stage=z((F,), torch.int8), fault_kind=f_kind.clone(),
        fault_peer=faults[:, 3].clone(), fault_sev=faults[:, 5].clone(),
        ds_down=z((D,), torch.bool), mw_heal=z((D,)), ds_heal=z((D, D)),
        tau_mw_eff=world.tau_true.clone(), tau_ds_eff=world.tau_ds.clone(),
        repl_tau=world.replica_tau.clone(), repl_lag_us=world.repl_lag_us.clone(),
        on_repl=z((T, D), torch.bool),
        stale_reads=s0(), failovers=s0(), max_stale_us=s0(),
        hb_time=full((D,), INF_US), hb_count=z((D,)), down_since=z((D,)), down_us=z((D,)),
        abort_cause=z((T,)), ab_cause=z((N_ABORT_CAUSES,)), commits_fault=s0(),
        hs=hs_mod.hash_init(cfg.hot_capacity + 1),
        tau_true=world.tau_true.clone(), tau_est=world.tau_true.clone(),
        tau_ds=world.tau_ds.clone(), jitter_milli=world.jitter_milli.clone(),
        exec_scale_milli=world.exec_scale_milli.clone(),
        lel_scale_milli=world.lel_scale_milli.clone(),
        clock_skew_us=world.clock_skew_us.clone(),
        commits=s0(), aborts=s0(), commits_dist=s0(), aborts_dist=s0(),
        lat_sum=s0(), lat_sum_dist=s0(),
        hist_all=z((HIST_BINS,)), hist_cen=z((HIST_BINS,)), hist_dist=z((HIST_BINS,)),
        lcs_sum=s0(), lcs_cnt=s0(), wan_legs=s0(), fast_commits=s0(), noops=s0(),
        drained=s0(), windows=s0(), win_stops=z((N_STOP_REASONS,)), fused=s0(),
        chained=s0(),
        slot_commits=z((T, nslot)), slot_aborts=z((T, nslot)), slot_lat=z((T, nslot)),
        dyn=world.dyn,
    )


def init_state_world(cfg: SimConfig, worlds: WorldSpec, device=None) -> SimState:
    """[B]-stacked initial state from [B]-stacked worlds, on `device`."""
    B = worlds.seed.shape[0]
    lanes = [init_state(cfg, tree_map(lambda x: x[b], worlds)) for b in range(B)]
    st = tree_map(lambda *xs: torch.stack(xs), *lanes)
    return tree_map(lambda x: x.to(device), st)


# ---------------------------------------------------------------------------
# small helpers (batched: per-lane scalars are [B] tensors)
# ---------------------------------------------------------------------------


def _delay_salted(jitter_milli, rtt, salt):
    """One-way delay = rtt/2 with deterministic ±jitter, int32, elementwise
    over broadcastable jitter/rtt/salt."""
    half = rtt // 2
    u = (_hash_u32(salt) % 2001).to(torch.int32) - 1000
    return half + (half * jitter_milli // 1000) * u // 1000


def _delay(s: SimState, rtt, salt):
    return _delay_salted(s.jitter_milli, rtt, salt)


def _salt(s: SimState, a: int) -> torch.Tensor:
    """int32 salt; `iters * _SALT_MUL` wraps in int32 as the reference."""
    return s.iters * _SALT_MUL + a


def _lane_gather(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x [B, D] gathered at d [B] or [B, ...] (int64)."""
    if d.dim() == 1:
        return x.gather(1, d[:, None])[:, 0]
    return x.gather(1, d.reshape(d.shape[0], -1)).reshape(d.shape)


def _lanes(x: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-lane [B] tensor viewed as [B, 1, ...] with `nd` dims, to
    broadcast against [B, ...] arrays of that rank."""
    return x.view(-1, *([1] * (nd - 1)))


def _dyn_view(dyn: DynProto, nd: int) -> DynProto:
    """Every [B] knob viewed with `nd` dims (`_lanes`)."""
    return DynProto(*(_lanes(x, nd) for x in dyn))


def _exec_us(cfg: SimConfig, s: SimState, d: torch.Tensor) -> torch.Tensor:
    """Per-op execution time at data source d ([B] or [B, ...] int64); the
    ScalarDB-style middleware CC pays one more DM round trip per statement."""
    if d.dim() > 2:
        return _exec_us(cfg, s, d.reshape(d.shape[0], -1)).reshape(d.shape)
    ex = s.dyn.exec_us if d.dim() == 1 else s.dyn.exec_us[:, None]
    cc = s.dyn.middleware_cc if d.dim() == 1 else s.dyn.middleware_cc[:, None]
    base = ex * _lane_gather(s.exec_scale_milli, d) // 1000
    return base + torch.where(cc, _lane_gather(s.tau_mw_eff, d), 0)


def _mw_send(s: SimState, on_r, d, t0):
    """Effective (departure base, link RTT) of a middleware<->d message, d
    [B] or [B, ...]: a replica-served subtxn rides the replica link, a
    severed primary link departs at its heal time. In a clean state this is
    (t0, tau_true[d])."""
    heal = _lane_gather(s.mw_heal, d)
    tau = torch.where(on_r, _lane_gather(s.repl_tau, d), _lane_gather(s.tau_mw_eff, d))
    return torch.where(~on_r & (heal > t0), heal, t0), tau


def _mw_link(s: SimState, on_r, d, t0):
    """`_mw_send`, reduced to the pristine (t0, tau_true[d]) when the state
    carries no fault schedule (F = 0 on the [B, F] fault leaves)."""
    if s.fault_time.shape[-1]:
        return _mw_send(s, on_r, d, t0)
    return t0, _lane_gather(s.tau_true, d)


def _ds_send(s: SimState, a, b, t0):
    """Effective (departure base, link RTT) of a geo-agent a -> b mesh
    message (a [B], b [B] or [B, M]): a severed link holds it until its heal
    time, DEGRADE scales the RTT. Clean: (t0, tau_ds[a, b])."""
    bidx = torch.arange(a.shape[0], device=a.device)
    heal = _lane_gather(s.ds_heal[bidx, a], b)
    return torch.maximum(t0, heal), _lane_gather(s.tau_ds_eff[bidx, a], b)


def _unreachable(s: SimState) -> torch.Tensor:
    """[B, D] data source crashed OR partitioned from the middleware: the
    gate of heartbeat probes, the availability charge and admission's
    fail-fast / failover."""
    return s.ds_down | (s.mw_heal > s.now[:, None])


def _round_done_transition(dyn, is_final, centralized, reply_t, prep_t, local_t, fast):
    """Subtxn state/time after its round's last statement finishes ([B])."""
    dec = dyn.prepare == PREPARE_DECENTRAL
    go_local = dec & dyn.async_local_commit & is_final & centralized
    go_fast = dec & is_final & ~centralized & (dyn.co_commit | fast)
    go_prep = dec & is_final & ~centralized & ~go_fast
    w = torch.where
    new_state = w(go_local | go_fast, SUB_LOCAL_COMMIT, w(go_prep, SUB_PREPARING, SUB_ROUND_REPLY))
    new_time = w(go_local, local_t, w(go_fast | go_prep, prep_t, reply_t))
    return new_state, new_time


def _put(x: torch.Tensor, ix: tuple, v) -> torch.Tensor:
    """One-lane scatter-set, out of place: `x` ([1, ...]) with lane 0's
    entries at the index tuple `ix` ([1] index tensors, or slices) set to
    `v` (a tensor broadcastable to them, cast to x's dtype, or a Python
    scalar). The sequential handlers' form of the reference's
    `x.at[ix].set(v)`."""
    if isinstance(v, torch.Tensor):
        return x[0].index_put(ix, v.to(x.dtype))[None]
    y = x.clone()
    y[0][ix] = v
    return y


def _add(x: torch.Tensor, ix: tuple, v: torch.Tensor) -> torch.Tensor:
    """One-lane scatter-add (`x.at[ix].add(v)`): duplicate indices
    accumulate."""
    return x[0].index_put(ix, v.to(x.dtype), accumulate=True)[None]


def _lock_wait_deadline(dyn, now):
    return now + torch.where(dyn.opt_abort, 0, dyn.lock_timeout_us)


def _tiga_arrival(dyn, clock_skew_us, now, arrival):
    deadline = now + dyn.tiga_slack_us
    fast = (dyn.tiga_slack_us > 0) & (arrival + clock_skew_us <= deadline)
    return torch.where(fast, deadline, arrival), fast


def _tiga_fast(dyn, single_round, inv_row, fast_row):
    all_fast = (~inv_row | fast_row).all(-1)
    return (dyn.tiga_slack_us > 0) & single_round & all_fast


def _u01(salt) -> torch.Tensor:
    return _hash_u32(salt).to(torch.float32) / float(2**32)


# Smallest latency (µs) of histogram bins 1..127 under the reference's
# float32 formula clip(int(8 * log(max(lat, 1) / 100) / log(2)), 0, 127).
# That formula is monotone in lat, so the bin is the number of thresholds
# <= lat: integer-exact on every device, where a float log differs by an
# ulp between libms and moves latencies near an edge into the next bin
# (tests/test_torch_netmodel.py holds it to the reference at every latency
# up to 7 s, the edges 100 * 2**m ± 1 included).
_HIST_THRESH_US = (
    110, 119, 130, 142, 155, 169, 184, 200, 219, 238, 260, 283, 309, 337, 367,
    400, 437, 476, 519, 566, 617, 673, 734, 800, 873, 952, 1038, 1132, 1234,
    1346, 1468, 1600, 1745, 1903, 2075, 2263, 2468, 2691, 2935, 3200, 3490,
    3806, 4150, 4526, 4936, 5382, 5869, 6400, 6980, 7611, 8300, 9051, 9871,
    10764, 11738, 12800, 13959, 15222, 16600, 18102, 19741, 21527, 23476,
    25600, 27917, 30444, 33200, 36204, 39481, 43054, 46951, 51200, 55834,
    60888, 66399, 72408, 78962, 86108, 93902, 102400, 111668, 121775, 132797,
    144816, 157923, 172216, 187803, 204800, 223336, 243550, 265593, 289631,
    315845, 344432, 375605, 409600, 446672, 487100, 531186, 579262, 631690,
    688862, 751210, 819201, 893344, 974199, 1062371, 1158525, 1263380,
    1377725, 1502420, 1638400, 1786687, 1948398, 2124742, 2317048, 2526758,
    2755448, 3004840, 3276801, 3573376, 3896793, 4249482, 4634097, 5053518,
    5510899, 6009677,
)


@functools.lru_cache(maxsize=None)
def _hist_thresholds(device: torch.device) -> torch.Tensor:
    """The threshold table on `device`, copied there once (a per-step host
    copy would synchronise the stream)."""
    return torch.tensor(_HIST_THRESH_US, dtype=torch.int32, device=device)


def _hist_bin(lat_us: torch.Tensor) -> torch.Tensor:
    return torch.bucketize(lat_us.to(torch.int32), _hist_thresholds(lat_us.device), right=True)


def _measuring(cfg: SimConfig, s: SimState) -> torch.Tensor:
    return s.now >= cfg.warmup_us


def _times_flat(s: SimState) -> torch.Tensor:
    """[B, T + T*D + T*K (+ F + D)] event-time view (term | sub | op |
    fault | heartbeat); the fault and heartbeat tails exist only when the
    state carries a fault schedule (F = `fault_time.shape[-1]` > 0)."""
    B = s.term_time.shape[0]
    parts = [s.term_time, s.sub_time.reshape(B, -1), s.op_time.reshape(B, -1)]
    if s.fault_time.shape[-1]:
        parts += [s.fault_time, s.hb_time]
    return torch.cat(parts, dim=1)
