"""Event handlers: the sequential (per-event) semantics of the engine (port
of `repro.core.engine.handlers`).

Hotspot / metric bookkeeping, DM-side protocol progress, the abort path and
the twelve fused event handlers `step._step` dispatches to (the lock-table
primitives they call live in `engine.locks`). These are the seed semantics
every other step mode (`omni`, `window`, `fused`) reproduces bitwise.

The handlers take a one-lane state: every `SimState` leaf carries the
port's leading lane axis with B = 1, and the event's coordinates `t` /
`idx` (`k` or `d`) are [1] int64 tensors. A reference scalar is a [1]
tensor here and a [T, K] array is [1, T, K]; `x[t]` reads `x[0, t]` and
`x.at[t].set(v)` is `state._put(x, (t,), v)`. So `interop`, `metrics`,
`window._window_plan` and `apply._apply_window` serve these lanes as they
are. The reference's inner `lax.cond`s become host branches on one read
of their predicates (`_flags`) a handler: on the card a read costs about
one eager op, and every branch it skips is several (PERF.md §6). The
result is bitwise the same as a masked write of both branches. This is the
reference's CPU strategy and the port's slow path on the card: which
kernels run depends on the event, so nothing here is captured into a CUDA
graph.

Eq.(8) (`_stagger`) and Eq.(9) (admission) go through
`scheduler.plan_dispatch`, the `geo_schedule` kernel on the card and its
plain version on the CPU, as in the lockstep steps.
"""

from __future__ import annotations

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core import scheduler as sched
from repro_torch.core.netmodel import INF_US, _hash_u32, ewma_update
from repro_torch.core.protocols import (
    PREPARE_COORD, PREPARE_DECENTRAL, PREPARE_NONE, STAGGER_NET_LEL, STAGGER_NONE,
)
from repro_torch.core.workloads import Bank
from repro_torch.core.engine.faults import _failover_admission, _failover_routing
from repro_torch.core.engine.locks import _attempt_lock, _release_and_grant
from repro_torch.core.engine.state import (
    OP_NONE, OP_PENDING, OP_ENROUTE, OP_QUEUED, OP_HOLD,
    SUB_NONE, SUB_SCHED, SUB_RUN, SUB_ROUND_REPLY, SUB_ROUND_AT_DM, SUB_WAIT_ROUND,
    SUB_CHILLER_WAIT, SUB_PREP_CMD, SUB_PREPARING, SUB_VOTE, SUB_VOTED,
    SUB_COMMIT_CMD, SUB_ACK, SUB_LOCAL_COMMIT, SUB_DONE, SUB_ABORT_PEER,
    SUB_ABORT_ACK, SUB_ABORTED,
    T_IDLE, T_ACTIVE, T_COMMIT_LOG, T_COMMIT_WAIT, T_ABORT_WAIT,
    CAUSE_NONE, CAUSE_TIMEOUT, CAUSE_ADMISSION, CAUSE_CRASH, CAUSE_EXHAUSTED,
    SimConfig, SimState,
    _add, _delay, _delay_salted, _ds_send, _hist_bin, _measuring, _mw_link, _put,
    _round_done_transition, _salt, _tiga_arrival, _tiga_fast, _u01, _unreachable,
)

I32 = torch.int32
I64 = torch.int64


def _c1(x: torch.Tensor) -> torch.Tensor:
    """[1] -> [1, 1], to broadcast a lane scalar against a [1, M] row."""
    return x[:, None]


def _flags(*preds: torch.Tensor) -> list:
    """The [1] bool predicates as Python bools, in one device-to-host read
    (the host form of the reference's `lax.cond` / `lax.switch`)."""
    return torch.cat([p.reshape(-1) for p in preds]).tolist()


def _ds_ids(s: SimState) -> torch.Tensor:
    """[1, D] int64 data-source ids (the reference's `jnp.arange(D)`)."""
    D = s.inv.shape[-1]
    return torch.arange(D, device=s.inv.device)[None]


# ---------------------------------------------------------------------------
# hotspot + metric helpers
# ---------------------------------------------------------------------------


def _hs_dispatch(cfg: SimConfig, s: SimState, keys, valid) -> SimState:
    """Claim hot-table slots for the txn's records ([1, K]) and bump
    a_cnt. Two keys racing for one empty slot: last writer wins, as the
    reference's scatter (`hotspot.last_writer_values`)."""
    hs = s.hs
    slot, evict = hs_mod.find_or_claim_slots(hs.slot_key, keys, valid)
    ztgt = torch.where(evict, slot, cfg.hot_capacity)
    zero_if = lambda f: f.scatter(1, ztgt, 0)  # noqa: E731
    hs = hs._replace(
        w_lat=zero_if(hs.w_lat),
        t_cnt=zero_if(hs.t_cnt),
        c_cnt=zero_if(hs.c_cnt),
        a_cnt=zero_if(hs.a_cnt),
    )
    key_new = hs_mod.last_writer_values(
        slot, torch.where(valid, keys, hs.slot_key.gather(1, slot))
    )
    hs = hs._replace(
        slot_key=hs.slot_key.scatter(1, slot, key_new),
        a_cnt=hs.a_cnt.scatter_add(1, slot, valid.to(I32)),
        clock=hs.clock.scatter(1, slot, 1),
    )
    return s._replace(hs=hs)


def _hs_complete_ds(cfg: SimConfig, s: SimState, t, d, committed) -> SimState:
    """Hotspot Eq.(4) update + a_cnt/t_cnt/c_cnt bookkeeping for subtxn
    (t, d); `committed` a [1] bool tensor."""
    mask = (s.op_state[0, t] != OP_NONE) & (s.op_ds[0, t].to(I64) == _c1(d))
    hs = s.hs
    slot, found = hs_mod.lookup_slots(hs.slot_key, s.op_key[0, t], mask)
    lel = s.sub_lel[0, t, d].to(torch.float32)
    new_w = hs_mod.eq4_masked_w(hs.w_lat, slot, found, _c1(lel), cfg.alpha_milli)
    # a duplicated key writes one identical Eq.(4) value and a miss writes
    # the scratch row back: the set is order-free; the counters add
    upd = found.to(I32)
    hs = hs._replace(
        w_lat=hs.w_lat.scatter(1, slot, torch.where(found, new_w, hs.w_lat.gather(1, slot))),
        a_cnt=torch.clamp_min(hs.a_cnt.scatter_add(1, slot, -upd), 0),
        t_cnt=hs.t_cnt.scatter_add(1, slot, upd),
        c_cnt=hs.c_cnt.scatter_add(1, slot, upd * _c1(committed).to(I32)),
    )
    return s._replace(hs=hs)


def _lcs_metric(cfg: SimConfig, s: SimState, t, d, gate=None) -> SimState:
    fl = s.first_lock[0, t, d]
    have = (fl < INF_US) & _measuring(cfg, s)
    if gate is not None:
        have = have & gate
    span_ms = torch.where(have, (s.now - fl + 500) // 1000, 0)
    return s._replace(lcs_sum=s.lcs_sum + span_ms, lcs_cnt=s.lcs_cnt + have.to(I32))


def _finish_txn(cfg: SimConfig, s: SimState, t, committed) -> SimState:
    """Terminal-side completion: metrics, reset, schedule next/retry."""
    N, F = cfg.bank_txns, cfg.max_faults
    w = torch.where
    now = s.now
    lat = now - s.arrive[0, t]
    dist = s.is_dist[0, t]
    meas = _measuring(cfg, s)
    b = _hist_bin(lat)
    slot = (s.cur[0, t] % N).to(I64)
    retries = s.retries[0, t]

    # abort-cause tally (first cause wins; a final abort that burned retries
    # is recorded as "exhausted") + fault-window goodput, tallied before the
    # reset below clears the pending cause; "during fault" means some DS is
    # unreachable (crashed, or partitioned from the middleware)
    will_retry = ~committed & (retries < s.dyn.max_retries)
    cause = w(~will_retry & (retries > 0), CAUSE_EXHAUSTED, s.abort_cause[0, t])
    any_down = (_unreachable(s) if F else s.ds_down).any(1)
    one_c = (meas & committed).to(I32)
    one_a = (meas & ~committed).to(I32)
    lat_ms = (lat + 500) // 1000
    # slot_* adds outside the tracked slots are dropped (mode="drop")
    in_slot = slot < s.slot_commits.shape[-1]
    j = w(in_slot, slot, 0)
    s = s._replace(
        ab_cause=_add(s.ab_cause, (cause.to(I64),), one_a),
        commits_fault=s.commits_fault + w(any_down, one_c, 0),
        commits=s.commits + one_c,
        aborts=s.aborts + one_a,
        commits_dist=s.commits_dist + w(dist, one_c, 0),
        aborts_dist=s.aborts_dist + w(dist, one_a, 0),
        lat_sum=s.lat_sum + one_c * lat_ms,
        lat_sum_dist=s.lat_sum_dist + w(dist, one_c, 0) * lat_ms,
        hist_all=_add(s.hist_all, (b,), one_c),
        hist_cen=_add(s.hist_cen, (b,), w(dist, 0, one_c)),
        hist_dist=_add(s.hist_dist, (b,), w(dist, one_c, 0)),
        slot_commits=_add(s.slot_commits, (t, j), w(in_slot, one_c, 0)),
        slot_aborts=_add(s.slot_aborts, (t, j), w(in_slot, one_a, 0)),
        slot_lat=_add(s.slot_lat, (t, j), w(in_slot, one_c * lat_ms, 0)),
    )
    # reset per-txn rows
    s = s._replace(
        op_state=_put(s.op_state, (t,), OP_NONE),
        op_time=_put(s.op_time, (t,), INF_US),
        inv=_put(s.inv, (t,), False),
        sub_state=_put(s.sub_state, (t,), SUB_NONE),
        sub_time=_put(s.sub_time, (t,), INF_US),
        sub_lel=_put(s.sub_lel, (t,), 0),
        first_lock=_put(s.first_lock, (t,), INF_US),
        rd_done=_put(s.rd_done, (t,), False),
        cur_round=_put(s.cur_round, (t,), 0),
        abort_cause=_put(s.abort_cause, (t,), CAUSE_NONE),
    )
    if F:  # a failed-over txn releases its replica routing
        s = s._replace(on_repl=_put(s.on_repl, (t,), False))
    # next / retry: randomized exponential backoff (breaks the deadlock
    # lockstep of terminals that would retry in phase), floored at 1 µs
    retry = will_retry
    base = s.dyn.retry_backoff_us
    h = _hash_u32(s.txn_ctr[0, t] * 977 + t.to(I32) * 131 + retries)
    jit = (h % torch.clamp_min(base, 1).to(I64)).to(I32)
    backoff = torch.clamp_min(base * (1 + torch.clamp_max(retries, 7)) + jit, 1)
    return s._replace(
        retries=_put(s.retries, (t,), w(retry, retries + 1, 0)),
        retry_same=_put(s.retry_same, (t,), retry),
        blocked=_put(s.blocked, (t,), 0),
        cur=_put(s.cur, (t,), s.cur[0, t] + (~retry).to(I32)),
        phase=_put(s.phase, (t,), T_IDLE),
        term_time=_put(s.term_time, (t,), w(committed, now, now + backoff)),
    )


# ---------------------------------------------------------------------------
# DM-side protocol progress
# ---------------------------------------------------------------------------


def _round_inv(s: SimState, t) -> torch.Tensor:
    """[1, D] which data sources have ops in txn t's current round."""
    row = s.op_state[0, t] != OP_NONE
    rd = s.op_round[0, t] == _c1(s.cur_round[0, t])
    oh = s.op_ds[0, t].to(I64)[..., None] == _ds_ids(s)
    return (oh & (row & rd)[..., None]).any(1)


def _lel_forecast(cfg: SimConfig, s: SimState, bidx, t) -> torch.Tensor:
    """Eq.(5) per data source for each lane's txn t: [B, D] int32 µs."""
    row = s.op_state[bidx, t] != OP_NONE
    slot, found = hs_mod.lookup_slots(s.hs.slot_key, s.op_key[bidx, t], row)
    w = s.hs.w_lat.gather(1, slot) * found.to(torch.int32)  # [B, K]
    D = s.inv.shape[-1]
    dd = torch.arange(D, device=w.device)
    oh = (s.op_ds[bidx, t].to(torch.int64)[..., None] == dd).to(torch.int32)  # [B,K,D]
    return (w[..., None] * oh).sum(1).to(torch.int32)


def _stagger(cfg: SimConfig, s: SimState, bidx, t, inv_mask) -> torch.Tensor:
    """Dispatch offsets per DS (Eq.3 / Eq.8 / none), selected by the
    dynamic stagger knob; Eq.(8) runs in the `geo_schedule` kernel (the
    Eq.(9) half of this launch is masked off with an all-False `valid`).
    `bidx` is the lanes' index ([B] tensor), or 0 for a one-lane state."""
    B, D = inv_mask.shape
    lel = (
        _lel_forecast(cfg, s, bidx, t).to(torch.float32)
        * s.lel_scale_milli.to(torch.float32)[:, None]
        / 1000.0
    ).to(torch.int32)
    lel = torch.where((s.dyn.stagger == STAGGER_NET_LEL)[:, None], lel, 0)
    zk = torch.zeros((B, 1), dtype=torch.int32, device=lel.device)
    off, _ = sched.plan_dispatch(
        s.tau_est, lel.contiguous(), inv_mask.contiguous(), zk, zk, zk, zk.to(torch.bool)
    )
    return torch.where((s.dyn.stagger == STAGGER_NONE)[:, None], 0, off)


def _dispatch_subs(cfg: SimConfig, s: SimState, t, mask, times) -> SimState:
    return s._replace(
        sub_state=_put(s.sub_state, (t,), torch.where(mask, SUB_SCHED, s.sub_state[0, t])),
        sub_time=_put(s.sub_time, (t,), torch.where(mask, times, s.sub_time[0, t])),
    )


def _dm_send(s: SimState, t, a: int) -> torch.Tensor:
    """[1, D] arrival times of a DM -> every DS message sent now (salt a)."""
    ids = _ds_ids(s)
    base, tau = _mw_link(s, s.on_repl[0, t], ids, _c1(s.now))
    return base + _delay_salted(_c1(s.jitter_milli), tau, _c1(_salt(s, a)) + ids.to(I32))


def _dm_progress(cfg: SimConfig, s: SimState, t) -> SimState:
    """Called whenever the DM hears from a data source: handles chiller
    stage-2 dispatch, interactive-round advancement, prepare broadcast (2PC)
    and the commit decision."""
    w = torch.where
    inv = s.inv[0, t]
    st = s.sub_state[0, t]
    centralized = inv.sum(1) == 1

    # chiller stage 2: when every dispatched (stage-1) sub has voted; the
    # decision below reads the row as the dispatch leaves it
    waiting = inv & (st == SUB_CHILLER_WAIT)
    active = inv & ~waiting
    ready = (~active | (st == SUB_VOTED)).all(1) & waiting.any(1) & s.dyn.chiller_two_stage
    st = w(waiting & _c1(ready), SUB_SCHED, st)

    inv_rd = _round_inv(s, t)
    all_rd = (~inv_rd | s.rd_done[0, t]).all(1)
    max_round = w(s.op_state[0, t] != OP_NONE, s.op_round[0, t], -1).amax(1)
    final = s.cur_round[0, t] >= max_round
    aborting = s.phase[0, t] == T_ABORT_WAIT
    # one-phase commit for centralized transactions (all protocols); the
    # no-prepare preset broadcasts commit as soon as every sub reported
    all_at_dm = (~inv | (st == SUB_ROUND_AT_DM)).all(1)
    all_voted = (~inv | (st == SUB_VOTED)).all(1)
    do_commit, do_prepare, do_log = sched.commit_decision(
        s.dyn.prepare, all_at_dm, all_voted, centralized,
        PREPARE_NONE, PREPARE_COORD, PREPARE_DECENTRAL,
    )
    rdy, go, fin, dc, dp, dl = _flags(
        ready, all_rd & ~aborting, final, do_commit, do_prepare, do_log
    )
    if rdy:
        s = _dispatch_subs(cfg, s, t, waiting, _c1(s.now))
    if not go:
        return s
    if not fin:  # advance to the next interactive round
        nxt = s.cur_round[0, t] + 1
        s = s._replace(
            cur_round=_put(s.cur_round, (t,), nxt),
            rd_done=_put(s.rd_done, (t,), False),
        )
        row = s.op_state[0, t] != OP_NONE
        oh = s.op_ds[0, t].to(I64)[..., None] == _ds_ids(s)
        inv_next = (oh & (row & (s.op_round[0, t] == _c1(nxt)))[..., None]).any(1)
        off = _stagger(cfg, s, 0, t, inv_next)
        return _dispatch_subs(cfg, s, t, inv_next, _c1(s.now) + off)
    if dc:  # send commit
        return s._replace(
            sub_state=_put(s.sub_state, (t,), w(inv, SUB_COMMIT_CMD, st)),
            sub_time=_put(s.sub_time, (t,), w(inv, _dm_send(s, t, 11), s.sub_time[0, t])),
            phase=_put(s.phase, (t,), T_COMMIT_WAIT),
            term_time=_put(s.term_time, (t,), INF_US),
        )
    if dp:  # send prepare
        return s._replace(
            sub_state=_put(s.sub_state, (t,), w(inv, SUB_PREP_CMD, st)),
            sub_time=_put(s.sub_time, (t,), w(inv, _dm_send(s, t, 13), s.sub_time[0, t])),
        )
    if dl:  # flush the commit log
        return s._replace(
            phase=_put(s.phase, (t,), T_COMMIT_LOG),
            term_time=_put(s.term_time, (t,), s.now + s.dyn.log_flush_us),
        )
    return s


# ---------------------------------------------------------------------------
# abort path
# ---------------------------------------------------------------------------


def _initiate_abort(cfg: SimConfig, s: SimState, t, d) -> SimState:
    """Lock-wait timeout at (t, d): abort the whole distributed transaction.
    With early_abort the geo-agent notifies peers directly (DS<->DS);
    otherwise the notification is routed through the DM (1.5 WAN rounds)."""
    w = torch.where
    s = _release_and_grant(cfg, s, t, d)
    s = _hs_complete_ds(cfg, s, t, d, torch.zeros_like(d, dtype=torch.bool))

    now = s.now
    inv = s.inv[0, t]
    st = s.sub_state[0, t]
    ids = _ds_ids(s)
    abort_family = (st == SUB_ABORT_PEER) | (st == SUB_ABORT_ACK) | (st == SUB_ABORTED)
    peers = inv & (ids != _c1(d)) & ~abort_family
    salts = _c1(_salt(s, 17)) + ids.to(I32)
    jit = _c1(s.jitter_milli)
    if cfg.max_faults:
        # abort notifications ride the effective links: degraded /
        # partitioned mesh links slow / hold the direct route, the via-DM
        # route crosses the timed-out sub's own middleware (or replica) link
        on_d = s.on_repl[0, t, d]
        mesh_base, mesh_tau = _ds_send(s, d, ids, _c1(now))
        notify_direct = mesh_base + _delay_salted(jit, mesh_tau, salts)
        up_base, up_tau = _mw_link(s, on_d, d, now)
        to_dm = up_base + _delay(s, up_tau, _salt(s, 19))
        dn_base, dn_tau = _mw_link(s, s.on_repl[0, t], ids, _c1(to_dm))
        notify_via_dm = dn_base + _delay_salted(jit, dn_tau, salts)
        notify = w(_c1(s.dyn.early_abort), notify_direct, notify_via_dm)
        own_ack = up_base + _delay(s, up_tau, _salt(s, 23))
    else:
        notify_direct = _delay_salted(jit, s.tau_ds[0, d], salts)
        to_dm = _delay(s, s.tau_true[0, d], _salt(s, 19))
        notify_via_dm = _c1(to_dm) + _delay_salted(jit, s.tau_true, salts)
        notify = _c1(now) + w(_c1(s.dyn.early_abort), notify_direct, notify_via_dm)
        own_ack = now + _delay(s, s.tau_true[0, d], _salt(s, 23))
    at_d = ids == _c1(d)
    new_st = w(at_d, SUB_ABORT_ACK, w(peers, SUB_ABORT_PEER, st))
    new_tm = w(at_d, _c1(own_ack), w(peers, notify, s.sub_time[0, t]))
    cause = s.abort_cause[0, t]
    return s._replace(
        sub_state=_put(s.sub_state, (t,), new_st),
        sub_time=_put(s.sub_time, (t,), new_tm),
        phase=_put(s.phase, (t,), T_ABORT_WAIT),
        term_time=_put(s.term_time, (t,), INF_US),
        # first cause wins (a second timeout during an in-flight abort must
        # not relabel it)
        abort_cause=_put(s.abort_cause, (t,), w(cause == CAUSE_NONE, CAUSE_TIMEOUT, cause)),
    )


# ---------------------------------------------------------------------------
# event handlers  (each: (cfg, bank, s, t, idx) -> s)
# ---------------------------------------------------------------------------


def _h_start_txn(cfg: SimConfig, bank: Bank, s: SimState, t, idx) -> SimState:
    """T_IDLE fires: load the txn from the bank, run O3 admission, compute the
    stagger (Eq.3/Eq.8) and dispatch round-0 subtransactions. `bank` is a
    one-lane bank (leaves [1, T, N, K])."""
    N, K, F = cfg.bank_txns, cfg.max_ops, cfg.max_faults
    w = torch.where
    now = s.now
    slot = (s.cur[0, t] % N).to(I64)
    key = bank.key[0, t, slot]  # [1, K]
    write = bank.write[0, t, slot]
    ds = bank.ds[0, t, slot]
    rnd = bank.round_id[0, t, slot]
    valid = bank.valid[0, t, slot]
    ids = _ds_ids(s)
    oh = ds.to(I64)[..., None] == ids[:, None]  # [1, K, D]
    inv = (oh & valid[..., None]).any(1)
    keym = w(valid, key, -1)
    s = s._replace(
        op_key=_put(s.op_key, (t,), keym),
        op_write=_put(s.op_write, (t,), write),
        op_ds=_put(s.op_ds, (t,), ds),
        op_round=_put(s.op_round, (t,), rnd),
        op_state=_put(s.op_state, (t,), w(valid, OP_PENDING, OP_NONE)),
        op_time=_put(s.op_time, (t,), INF_US),
        inv=_put(s.inv, (t,), inv),
        is_dist=_put(s.is_dist, (t,), inv.sum(1) > 1),
        cur_round=_put(s.cur_round, (t,), 0),
        rd_done=_put(s.rd_done, (t,), False),
        sub_lel=_put(s.sub_lel, (t,), 0),
        first_lock=_put(s.first_lock, (t,), INF_US),
        txn_ctr=_put(s.txn_ctr, (t,), s.txn_ctr[0, t] + 1),
    )

    # ---- O3 late transaction scheduling (Eq.9, through the kernel) --------
    hs = s.hs
    slot_a, found = hs_mod.lookup_slots(hs.slot_key, keym, valid)
    fa = found.to(I32)
    zd = torch.zeros((1, 1), dtype=I32, device=now.device)
    _, p_raw = sched.plan_dispatch(
        zd, zd, zd.to(torch.bool),
        hs.c_cnt.gather(1, slot_a) * fa, hs.t_cnt.gather(1, slot_a) * fa,
        hs.a_cnt.gather(1, slot_a) * fa, valid.contiguous(),
    )
    p_abort = torch.minimum(p_raw, s.dyn.block_prob_cap)
    u = _u01(_salt(s, 29) + t.to(I32))
    block, force_abort = sched.admission_decision(
        p_abort, u, s.blocked[0, t], s.dyn.max_blocked
    )
    block = block & s.dyn.admission
    # fail fast when the footprint touches an unreachable data source,
    # unless every unreachable DS of it has a replica and the txn only reads
    # there: then the whole txn fails over to the replicas
    if F:
        hit_down, fo = _failover_admission(s, inv, oh, valid, write, now)
    else:
        hit_down = (inv & s.ds_down).any(1)
    force_abort = (force_abort & s.dyn.admission) | hit_down
    do_abort, do_block = _flags(force_abort, block)

    if do_abort:  # admission / fail-fast abort: nothing dispatched; count + retry
        s = s._replace(
            arrive=_put(s.arrive, (t,), now),
            abort_cause=_put(s.abort_cause, (t,), w(hit_down, CAUSE_CRASH, CAUSE_ADMISSION)),
        )
        return _finish_txn(cfg, s, t, torch.zeros_like(force_abort))
    if do_block:
        return s._replace(
            blocked=_put(s.blocked, (t,), s.blocked[0, t] + 1),
            term_time=_put(s.term_time, (t,), now + s.dyn.admission_backoff_us),
        )

    # ---- dispatch -----------------------------------------------------------
    s = _hs_dispatch(cfg, s, keym, valid)
    s = s._replace(arrive=_put(s.arrive, (t,), now))
    if F:
        # replica failover bookkeeping: route the hit subtxns to their
        # replicas, count the failovers and the stale read statements, and
        # record the staleness window (outage age + replication lag)
        yes = torch.ones_like(force_abort)
        s = _failover_routing(s, t, now, fo, yes, ~yes, valid, write, ds)
    inv0 = (oh & (valid & (rnd == 0))[..., None]).any(1)
    off = _stagger(cfg, s, 0, t, inv0)
    # chiller: intra-region (min-RTT) subs first; cross-region wait
    # (§VII-A-1). Selected dynamically against the standard dispatch.
    tmin = w(inv0, s.tau_est, INF_US).amin(1)
    stage1 = inv0 & (s.tau_est <= _c1(tmin))
    stage2 = inv0 & ~stage1
    chil_state = w(stage2, SUB_CHILLER_WAIT, w(stage1, SUB_SCHED, SUB_NONE))
    chil_time = w(stage1, _c1(now), INF_US)
    later = inv & ~inv0
    norm_state = w(inv0, SUB_SCHED, w(later, SUB_WAIT_ROUND, SUB_NONE))
    norm_time = w(inv0, _c1(now) + off, INF_US)
    chiller = _c1(s.dyn.chiller_two_stage)
    return s._replace(
        sub_state=_put(s.sub_state, (t,), w(chiller, chil_state, norm_state)),
        sub_time=_put(s.sub_time, (t,), w(chiller, chil_time, norm_time)),
        phase=_put(s.phase, (t,), T_ACTIVE),
        term_time=_put(s.term_time, (t,), INF_US),
    )


def _h_send_commits(cfg: SimConfig, bank, s: SimState, t, idx) -> SimState:
    """T_COMMIT_LOG fires: the DM flushed the commit log — broadcast commit."""
    inv = s.inv[0, t]
    w = torch.where
    return s._replace(
        sub_state=_put(s.sub_state, (t,), w(inv, SUB_COMMIT_CMD, s.sub_state[0, t])),
        sub_time=_put(s.sub_time, (t,), w(inv, _dm_send(s, t, 31), s.sub_time[0, t])),
        phase=_put(s.phase, (t,), T_COMMIT_WAIT),
        term_time=_put(s.term_time, (t,), INF_US),
    )


def _h_op_arrive(cfg: SimConfig, bank, s: SimState, t, k) -> SimState:
    """OP_ENROUTE fires: the round's first statement reaches the DS."""
    s = s._replace(wan_legs=s.wan_legs + 1)  # DM -> DS statement leg lands
    return _attempt_lock(cfg, s, t, k)


def _h_op_timeout(cfg: SimConfig, bank, s: SimState, t, k) -> SimState:
    """OP_WAIT fires: lock-wait timeout — abort the transaction."""
    d = s.op_ds[0, t, k].to(I64)
    # account the partial round into LEL before aborting
    span = torch.clamp_min(s.now - s.sub_arrive[0, t, d], 0)
    s = s._replace(sub_lel=_add(s.sub_lel, (t, d), span))
    return _initiate_abort(cfg, s, t, d)


def _h_op_exec_done(cfg: SimConfig, bank, s: SimState, t, k) -> SimState:
    """OP_EXEC fires: statement finished; chain the next statement of this
    subtransaction or complete the round."""
    w = torch.where
    d = s.op_ds[0, t, k].to(I64)
    s = s._replace(
        op_state=_put(s.op_state, (t, k), OP_HOLD),
        op_time=_put(s.op_time, (t, k), INF_US),
    )
    row = s.op_state[0, t]
    same_d = s.op_ds[0, t].to(I64) == _c1(d)
    nxt_mask = (row == OP_QUEUED) & same_d & (s.op_round[0, t] == _c1(s.cur_round[0, t]))
    has_next, = _flags(nxt_mask.any(1))
    if has_next:  # chain
        return _attempt_lock(cfg, s, t, nxt_mask.to(I32).argmax(1))

    # round done
    now = s.now
    span = torch.clamp_min(now - s.sub_arrive[0, t, d], 0)
    s = s._replace(sub_lel=_add(s.sub_lel, (t, d), span))
    opn = s.op_state[0, t] != OP_NONE
    d_final = w(opn & same_d, s.op_round[0, t], -1).amax(1)
    is_final = s.cur_round[0, t] >= d_final
    centralized = s.inv[0, t].sum(1) == 1
    aborting = s.sub_state[0, t, d] == SUB_ABORT_PEER  # peer abort in flight
    rbase, rtau = _mw_link(s, s.on_repl[0, t, d], d, now)
    reply_t = rbase + _delay(s, rtau, _salt(s, 37))
    prep_t = now + s.dyn.lan_rtt_us + s.dyn.log_flush_us
    local_t = now + s.dyn.log_flush_us
    single = w(opn, s.op_round[0, t], 0).amax(1) == 0
    fast = _tiga_fast(s.dyn, single, s.inv[0, t], s.sub_fast[0, t])
    new_state, new_time = _round_done_transition(
        s.dyn, is_final, centralized, reply_t, prep_t, local_t, fast
    )
    return s._replace(
        fast_commits=s.fast_commits + (~aborting & (new_state == SUB_LOCAL_COMMIT)).to(I32),
        sub_state=_put(s.sub_state, (t, d), w(aborting, s.sub_state[0, t, d], new_state)),
        sub_time=_put(s.sub_time, (t, d), w(aborting, s.sub_time[0, t, d], new_time)),
    )


def _h_sub_dispatch(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    """SUB_SCHED fires: DM sends the current round's statements to DS d.

    Under TIGA the statements carry the synchronized-clock deadline
    `now + tiga_slack_us`: an arrival that beats it (clock skew included)
    buffers and executes at the deadline, and the `sub_fast` flag feeds the
    round-done single-round commit check."""
    w = torch.where
    now = s.now
    abase, atau = _mw_link(s, s.on_repl[0, t, d], d, now)
    arrival = abase + _delay(s, atau, _salt(s, 41))
    first_t, fast = _tiga_arrival(s.dyn, s.clock_skew_us, now, arrival)
    row = s.op_state[0, t]
    mask = (
        (row == OP_PENDING)
        & (s.op_ds[0, t].to(I64) == _c1(d))
        & (s.op_round[0, t] == _c1(s.cur_round[0, t]))
    )
    first = mask.to(I32).argmax(1)
    kk = torch.arange(cfg.max_ops, device=now.device)
    new_row = w(mask, w(kk == _c1(first), OP_ENROUTE, OP_QUEUED), row)
    return s._replace(
        op_state=_put(s.op_state, (t,), new_row),
        op_time=_put(s.op_time, (t, first), w(mask.any(1), first_t, s.op_time[0, t, first])),
        sub_state=_put(s.sub_state, (t, d), SUB_RUN),
        sub_time=_put(s.sub_time, (t, d), INF_US),
        sub_arrive=_put(s.sub_arrive, (t, d), arrival),
        sub_fast=_put(s.sub_fast, (t, d), fast),
    )


def _ewma_est(cfg: SimConfig, s: SimState, t, d) -> SimState:
    # the monitor samples the *effective* link RTT, so a DEGRADE is observed
    # and the latency-aware scheduler re-plans around the slow link
    if cfg.max_faults:
        sample = s.tau_mw_eff[0, d]
        # monitor freeze: messages already in flight from a now-crashed DS
        # must not feed the latency EWMA, and replica-link fan-ins say
        # nothing about the (unreachable) primary link
        freeze = s.ds_down[0, d] | s.on_repl[0, t, d]
    else:
        sample = s.tau_true[0, d]
        freeze = s.ds_down[0, d]  # all-False on fault-free runs
    old = s.tau_est[0, d]
    new = torch.where(freeze, old, ewma_update(old, sample, cfg.beta_milli))
    return s._replace(tau_est=_put(s.tau_est, (d,), new))


def _h_dm_round_in(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    """SUB_ROUND_REPLY / SUB_VOTE fires at the DM (one fused handler for
    both fan-ins: they differ only in the recorded sub state)."""
    is_reply = s.sub_state[0, t, d] == SUB_ROUND_REPLY
    s = _ewma_est(cfg, s, t, d)
    s = s._replace(
        wan_legs=s.wan_legs + 1,  # DS -> DM reply/vote leg lands
        sub_state=_put(s.sub_state, (t, d), torch.where(is_reply, SUB_ROUND_AT_DM, SUB_VOTED)),
        sub_time=_put(s.sub_time, (t, d), INF_US),
        rd_done=_put(s.rd_done, (t, d), True),
    )
    return _dm_progress(cfg, s, t)


def _h_ds_prep_cmd(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    """SUB_PREP_CMD fires at DS (coordinated 2PC prepare)."""
    return s._replace(
        wan_legs=s.wan_legs + 1,  # DM -> DS prepare-command leg lands
        sub_state=_put(s.sub_state, (t, d), SUB_PREPARING),
        sub_time=_put(s.sub_time, (t, d), s.now + s.dyn.log_flush_us),
    )


def _h_ds_prepared(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    """SUB_PREPARING fires: WAL flushed; send the vote to the DM."""
    vbase, vtau = _mw_link(s, s.on_repl[0, t, d], d, s.now)
    return s._replace(
        sub_state=_put(s.sub_state, (t, d), SUB_VOTE),
        sub_time=_put(s.sub_time, (t, d), vbase + _delay(s, vtau, _salt(s, 43))),
    )


def _h_ds_finish(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    """SUB_COMMIT_CMD / SUB_LOCAL_COMMIT / SUB_ABORT_PEER fires at DS d:
    apply (or roll back), release locks and ack back to the DM (one fused
    handler for the three lock-releasing DS events)."""
    st0 = s.sub_state[0, t, d]
    is_commit = (st0 == SUB_COMMIT_CMD) | (st0 == SUB_LOCAL_COMMIT)
    # WAN legs landing here: DM->DS commit commands always rode the WAN,
    # local commits were decided at the DS (no leg), abort commands only
    # when routed via the DM (the early-abort route is geo-agent mesh)
    s = s._replace(
        wan_legs=s.wan_legs + (st0 == SUB_COMMIT_CMD).to(I32)
        + ((st0 == SUB_ABORT_PEER) & ~s.dyn.early_abort).to(I32)
    )
    s = _lcs_metric(cfg, s, t, d, gate=is_commit)
    s = _hs_complete_ds(cfg, s, t, d, is_commit)
    s = _release_and_grant(cfg, s, t, d)
    salt = _salt(s, 47) + torch.where(is_commit, 0, 6)  # 47 commit, 53 abort
    kbase, ktau = _mw_link(s, s.on_repl[0, t, d], d, s.now)
    return s._replace(
        sub_state=_put(s.sub_state, (t, d), torch.where(is_commit, SUB_ACK, SUB_ABORT_ACK)),
        sub_time=_put(s.sub_time, (t, d), kbase + _delay(s, ktau, salt)),
    )


def _h_dm_fin(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    """SUB_ACK / SUB_ABORT_ACK fires at the DM: the transaction completes
    when the last ack arrives (fused commit/abort fan-in)."""
    committed = s.sub_state[0, t, d] == SUB_ACK
    s = _ewma_est(cfg, s, t, d)
    want = torch.where(committed, SUB_DONE, SUB_ABORTED)
    s = s._replace(
        wan_legs=s.wan_legs + 1,  # DS -> DM finish-ack leg lands
        sub_state=_put(s.sub_state, (t, d), want),
        sub_time=_put(s.sub_time, (t, d), INF_US),
    )
    done, = _flags((~s.inv[0, t] | (s.sub_state[0, t] == _c1(want))).all(1))
    return _finish_txn(cfg, s, t, committed) if done else s


def _h_noop(cfg: SimConfig, bank, s: SimState, t, d) -> SimState:
    # Safety valve: an event fired in an unexpected state. Clear it so the
    # loop cannot spin; `noops` must stay 0 (checked by the callers).
    w = torch.where
    now = s.now
    upd = dict(
        op_time=w(s.op_time == now, INF_US, s.op_time),
        sub_time=w(s.sub_time == now, INF_US, s.sub_time),
        term_time=w(s.term_time == now, INF_US, s.term_time),
        noops=s.noops + 1,
    )
    if cfg.max_faults:  # fault sections exist only when max_faults > 0
        upd.update(
            fault_time=w(s.fault_time == now, INF_US, s.fault_time),
            hb_time=w(s.hb_time == now, INF_US, s.hb_time),
        )
    return s._replace(**upd)
