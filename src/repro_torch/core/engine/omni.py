"""Branchless omnibus step over B lockstep lanes (port of
`repro.core.engine.omni._omni_step`, the `SimConfig(lockstep=True,
drain=False)` path of the reference's vmap strategy).

One straight-line masked pass per step: every lane processes its own
earliest event; each handler is an identity-when-off masked delta gated by
its category flag. The reference runs this under `jax.vmap`; here the [B]
lane axis is written out, with explicit lane indexing (`x[bidx, t]`,
`bidx = arange(B)`). Same event pick and tie-break (first occurrence), same
salts, same update formulas and float order, so every lane's trajectory is
bitwise the reference's. With a fault schedule (`cfg.max_faults > 0`)
the reference's `if F:` branches run too: admission's fail-fast and
replica failover, the links' heal-time and replica routing, the monitor on
the effective link, and the fault / heartbeat tail events, run last.

Eq.(9) (admission) and Eq.(8) (stagger) go through the `geo_schedule`
kernel, once each per step: Eq.(9) reads the hot table before the claim,
Eq.(8)'s forecast after it.
"""

from __future__ import annotations

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core import scheduler as sched
from repro_torch.core.netmodel import INF_US, _hash_u32, ewma_update
from repro_torch.core.protocols import PREPARE_COORD, PREPARE_DECENTRAL, PREPARE_NONE
from repro_torch.core.workloads import Bank
from repro_torch.core.engine.faults import (
    _failover_admission, _failover_routing, _fault_event, _hb_event, _tail_event,
)
from repro_torch.core.engine.handlers import _stagger
from repro_torch.core.engine.locks import _grant_decision
from repro_torch.core.engine.state import (
    OP_NONE, OP_PENDING, OP_ENROUTE, OP_QUEUED, OP_WAIT, OP_EXEC, OP_HOLD, OP_DONE,
    SUB_NONE, SUB_SCHED, SUB_RUN, SUB_ROUND_REPLY, SUB_ROUND_AT_DM, SUB_WAIT_ROUND,
    SUB_CHILLER_WAIT, SUB_PREP_CMD, SUB_PREPARING, SUB_VOTE, SUB_VOTED,
    SUB_COMMIT_CMD, SUB_ACK, SUB_LOCAL_COMMIT, SUB_DONE, SUB_ABORT_PEER,
    SUB_ABORT_ACK, SUB_ABORTED,
    T_IDLE, T_ACTIVE, T_COMMIT_LOG, T_COMMIT_WAIT, T_ABORT_WAIT,
    CAUSE_NONE, CAUSE_TIMEOUT, CAUSE_ADMISSION, CAUSE_CRASH, CAUSE_EXHAUSTED,
    SimConfig, SimState,
    _delay, _delay_salted, _ds_send, _exec_us, _hist_bin, _lock_wait_deadline, _measuring,
    _mw_link, _round_done_transition, _salt, _tiga_arrival, _tiga_fast, _times_flat, _u01,
    _unreachable,
)

I8 = torch.int8
I32 = torch.int32


def _omni_step(cfg: SimConfig, bank: Bank, s: SimState) -> SimState:
    """Process each lane's earliest event as ONE masked pass.

    `bank` leaves carry a leading [B] axis (a shared bank is expanded, not
    copied). Returns the next state of every lane; `batch.run` keeps the
    state of lanes that were already done (the vmap lane freeze)."""
    T, D, K, N, F = cfg.terminals, cfg.num_ds, cfg.max_ops, cfg.bank_txns, cfg.max_faults
    M0 = T + T * D + T * K
    C = cfg.hot_capacity
    w = torch.where
    dev = s.now.device
    B = s.now.shape[0]
    bidx = torch.arange(B, device=dev)
    kk = torch.arange(K, device=dev)
    dd = torch.arange(D, device=dev)
    dd32 = dd.to(I32)

    def row(x):  # lane b's row t: [B, ...]
        return x[bidx, t]

    def put_row(x, v):
        return x.index_put((bidx, t), v.to(x.dtype))

    def put_at(x, j, v):
        return x.index_put((bidx, t, j), v.to(x.dtype))

    # ---- event pick (first-occurrence argmin) -------------------------------
    flat = _times_flat(s)
    i = flat.argmin(1)
    t_now = flat.gather(1, i[:, None])[:, 0]
    is_term = i < T
    is_sub = ~is_term & (i < T + T * D)
    is_op = ~is_term & ~is_sub
    j_sub = i - T
    j_op = i - T - T * D
    t = w(is_term, i, w(is_sub, j_sub // D, j_op // K))
    idx = w(is_sub, j_sub % D, w(is_term, 0, j_op % K))
    if F:
        # fault / heartbeat tail sections: their masked handlers run at the
        # very end of the pass, everything before is identity for them
        is_fault_ev, is_hb_ev, f_ev, d_hb = _tail_event(i, M0, F, D)
        is_tail = is_fault_ev | is_hb_ev
        is_op = is_op & ~is_tail
        t = w(is_tail, 0, t)
        idx = w(is_tail, 0, idx)
    k_ev = idx.clamp(max=K - 1)
    d_ev = idx.clamp(max=D - 1)
    s = s._replace(now=t_now, iters=s.iters + 1)
    now = s.now
    c1 = lambda x: x[:, None]  # [B] -> [B, 1]

    # ---- category flags -----------------------------------------------------
    sub0 = s.sub_state[bidx, t, d_ev].to(I32)
    op0 = s.op_state[bidx, t, k_ev].to(I32)
    ph0 = row(s.phase).to(I32)
    is_start = is_term & (ph0 == T_IDLE)
    is_logflush = is_term & (ph0 == T_COMMIT_LOG)
    is_arrive = is_op & (op0 == OP_ENROUTE)
    is_timeout = is_op & (op0 == OP_WAIT)
    is_exec = is_op & (op0 == OP_EXEC)
    is_sched = is_sub & (sub0 == SUB_SCHED)
    is_reply = is_sub & (sub0 == SUB_ROUND_REPLY)
    is_vote = is_sub & (sub0 == SUB_VOTE)
    is_round_in = is_reply | is_vote
    is_prep_cmd = is_sub & (sub0 == SUB_PREP_CMD)
    is_prepared = is_sub & (sub0 == SUB_PREPARING)
    is_commit_fin = is_sub & ((sub0 == SUB_COMMIT_CMD) | (sub0 == SUB_LOCAL_COMMIT))
    is_abort_fin = is_sub & (sub0 == SUB_ABORT_PEER)
    is_finish = is_commit_fin | is_abort_fin
    is_ack = is_sub & (sub0 == SUB_ACK)
    is_abort_ack = is_sub & (sub0 == SUB_ABORT_ACK)
    is_fin_ack = is_ack | is_abort_ack
    is_noop = ~(
        is_start | is_logflush | is_arrive | is_timeout | is_exec | is_sched
        | is_round_in | is_prep_cmd | is_prepared | is_finish | is_fin_ack
    )
    if F:
        is_noop = is_noop & ~is_tail
    d_o = s.op_ds[bidx, t, k_ev].to(torch.int64)  # the op event's data source

    # =================== txn start: bank load + admission ====================
    slot_b = (row(s.cur) % N).to(torch.int64)
    key_b = bank.key[bidx, t, slot_b]
    write_b = bank.write[bidx, t, slot_b]
    ds_b = bank.ds[bidx, t, slot_b]
    rnd_b = bank.round_id[bidx, t, slot_b]
    valid_b = bank.valid[bidx, t, slot_b]
    oh_b = ds_b.to(torch.int64)[..., None] == dd  # [B, K, D]
    inv_new = (oh_b & valid_b[..., None]).any(1)
    st = c1(is_start)

    s = s._replace(
        op_key=put_row(s.op_key, w(st, w(valid_b, key_b, -1), row(s.op_key))),
        op_write=put_row(s.op_write, w(st, write_b, row(s.op_write))),
        op_ds=put_row(s.op_ds, w(st, ds_b, row(s.op_ds))),
        op_round=put_row(s.op_round, w(st, rnd_b, row(s.op_round))),
        op_state=put_row(
            s.op_state, w(st, w(valid_b, OP_PENDING, OP_NONE), row(s.op_state).to(I32))
        ),
        op_time=put_row(s.op_time, w(st, INF_US, row(s.op_time))),
        inv=put_row(s.inv, w(st, inv_new, row(s.inv))),
        is_dist=put_row(
            s.is_dist, w(is_start, inv_new.to(I32).sum(1) > 1, row(s.is_dist))
        ),
        cur_round=put_row(s.cur_round, w(is_start, 0, row(s.cur_round).to(I32))),
        first_lock=put_row(s.first_lock, w(st, INF_US, row(s.first_lock))),
        txn_ctr=put_row(s.txn_ctr, row(s.txn_ctr) + is_start.to(I32)),
    )
    rd_done_row = w(st, False, row(s.rd_done))
    sub_lel_row = w(st, 0, row(s.sub_lel))
    inv_t = row(s.inv)

    # O3 admission (Eq.9 through the kernel), read on the pre-claim table
    hs = s.hs
    keym = w(valid_b, key_b, -1)
    slot_a, found_a = hs_mod.lookup_slots(hs.slot_key, keym, valid_b)
    fa = found_a.to(I32)
    zd = torch.zeros((B, 1), dtype=I32, device=dev)
    _, p_raw = sched.plan_dispatch(
        zd, zd, zd.to(torch.bool),
        hs.c_cnt.gather(1, slot_a) * fa, hs.t_cnt.gather(1, slot_a) * fa,
        hs.a_cnt.gather(1, slot_a) * fa, valid_b.contiguous(),
    )
    p_abort = torch.minimum(p_raw, s.dyn.block_prob_cap)
    u = _u01(_salt(s, 29) + t.to(I32))
    block, force_abort = sched.admission_decision(
        p_abort, u, row(s.blocked), s.dyn.max_blocked
    )
    if F:
        hit_v, fo = _failover_admission(s, inv_new, oh_b, valid_b, write_b, now)
        hit_down = is_start & hit_v
    else:
        hit_down = is_start & (inv_new & s.ds_down).any(1)
    force_abort = (force_abort & s.dyn.admission & is_start) | hit_down
    block = block & s.dyn.admission & is_start & ~force_abort
    dispatching = is_start & ~block & ~force_abort
    dsp = c1(dispatching)

    # hot-table claim (dispatch only; identity-valued writes otherwise)
    claim_valid = valid_b & dsp
    slot_c, evict = hs_mod.find_or_claim_slots(hs.slot_key, keym, claim_valid)
    ztgt = w(evict, slot_c, C)
    zval = lambda f: w(dsp, 0, f.gather(1, ztgt))
    hs = hs._replace(
        w_lat=hs.w_lat.scatter(1, ztgt, zval(hs.w_lat)),
        t_cnt=hs.t_cnt.scatter(1, ztgt, zval(hs.t_cnt)),
        c_cnt=hs.c_cnt.scatter(1, ztgt, zval(hs.c_cnt)),
        a_cnt=hs.a_cnt.scatter(1, ztgt, zval(hs.a_cnt)),
    )
    # two keys racing for one slot: pinned to last-wins (hotspot.py docs)
    key_new = hs_mod.last_writer_values(
        slot_c, w(claim_valid, keym, hs.slot_key.gather(1, slot_c))
    )
    hs = hs._replace(
        slot_key=hs.slot_key.scatter(1, slot_c, key_new),
        a_cnt=hs.a_cnt.scatter_add(1, slot_c, claim_valid.to(I32)),
        clock=hs.clock.scatter(
            1, slot_c, w(dsp, 1, hs.clock.gather(1, slot_c).to(I32)).to(I8)
        ),
    )
    s = s._replace(
        hs=hs,
        arrive=put_row(s.arrive, w(dispatching | force_abort, now, row(s.arrive))),
        blocked=put_row(s.blocked, row(s.blocked) + block.to(I32)),
        abort_cause=put_row(
            s.abort_cause,
            w(force_abort, w(hit_down, CAUSE_CRASH, CAUSE_ADMISSION), row(s.abort_cause)),
        ),
    )

    # ============ op events: exec completion, chained lock attempt ===========
    s = s._replace(
        op_state=put_at(
            s.op_state, k_ev, w(is_exec, OP_HOLD, s.op_state[bidx, t, k_ev].to(I32))
        ),
        op_time=put_at(s.op_time, k_ev, w(is_exec, INF_US, s.op_time[bidx, t, k_ev])),
    )
    row_st = row(s.op_state).to(I32)
    nxt_mask = (
        (row_st == OP_QUEUED)
        & (row(s.op_ds).to(torch.int64) == c1(d_o))
        & (row(s.op_round) == c1(row(s.cur_round)))
    )
    has_next = nxt_mask.any(1)
    nxt = nxt_mask.to(I32).argmax(1)
    do_lock = is_arrive | (is_exec & has_next)
    k_lock = w(is_arrive, k_ev, nxt)

    # one shared lock attempt (FIFO-fair 2PL)
    r_l = s.op_key[bidx, t, k_lock]
    w_l = s.op_write[bidx, t, k_lock]
    d_l = s.op_ds[bidx, t, k_lock].to(torch.int64)
    stf = s.op_state.to(I32)
    on_r = s.op_key == r_l[:, None, None]
    holder = (stf == OP_EXEC) | (stf == OP_HOLD)
    x_held = (holder & on_r & s.op_write).flatten(1).any(1)
    s_held = (holder & on_r & ~s.op_write).flatten(1).any(1)
    waiter = ((stf == OP_WAIT) & on_r).flatten(1).any(1)
    lock_ok = w(w_l, ~x_held & ~s_held, ~x_held) & ~waiter
    exec_t = now + _exec_us(cfg, s, d_l)
    s = s._replace(
        op_state=put_at(
            s.op_state, k_lock,
            w(do_lock, w(lock_ok, OP_EXEC, OP_WAIT), s.op_state[bidx, t, k_lock].to(I32)),
        ),
        op_time=put_at(
            s.op_time, k_lock,
            w(do_lock, w(lock_ok, exec_t, _lock_wait_deadline(s.dyn, now)),
              s.op_time[bidx, t, k_lock]),
        ),
        op_enq=put_at(s.op_enq, k_lock, w(do_lock, now, s.op_enq[bidx, t, k_lock])),
        first_lock=put_at(
            s.first_lock, d_l,
            torch.minimum(s.first_lock[bidx, t, d_l], w(do_lock & lock_ok, now, INF_US)),
        ),
    )

    # round completion at (t, d_o)
    rd = is_exec & ~has_next
    g_lel = rd | is_timeout
    span_do = torch.clamp_min(now - s.sub_arrive[bidx, t, d_o], 0)
    j_lel = w(g_lel, d_o, 0)
    sub_lel_row = sub_lel_row.index_put(
        (bidx, j_lel), sub_lel_row[bidx, j_lel] + w(g_lel, span_do, 0)
    )
    row_nn = row(s.op_state) != OP_NONE
    d_final = w(
        row_nn & (row(s.op_ds).to(torch.int64) == c1(d_o)), row(s.op_round).to(I32), -1
    ).amax(1)
    rd_is_final = row(s.cur_round).to(I32) >= d_final
    centralized = inv_t.to(I32).sum(1) == 1
    rd_aborting = s.sub_state[bidx, t, d_o].to(I32) == SUB_ABORT_PEER
    # the middleware links at d_o and d_ev (routing and link state cannot
    # change before the step's end)
    do_base, tau_do = _mw_link(s, s.on_repl[bidx, t, d_o], d_o, now)
    ev_base, tau_ev = _mw_link(s, s.on_repl[bidx, t, d_ev], d_ev, now)
    reply_t_rd = do_base + _delay(s, tau_do, _salt(s, 37))
    prep_t_rd = now + s.dyn.lan_rtt_us + s.dyn.log_flush_us
    local_t_rd = now + s.dyn.log_flush_us
    single_rd = w(row_nn, row(s.op_round), 0).amax(1) == 0
    fast_rd = _tiga_fast(s.dyn, single_rd, inv_t, row(s.sub_fast))
    rd_state, rd_time = _round_done_transition(
        s.dyn, rd_is_final, centralized, reply_t_rd, prep_t_rd, local_t_rd, fast_rd
    )

    # ===================== subtxn row (ordered masked writes) ================
    sub_row = row(s.sub_state).to(I32)
    sub_tm = row(s.sub_time)
    at_ev = dd == c1(d_ev)
    at_do = dd == c1(d_o)
    g_rd = rd & ~rd_aborting
    sub_row = w(c1(g_rd) & at_do, c1(rd_state), sub_row)
    sub_tm = w(c1(g_rd) & at_do, c1(rd_time), sub_tm)
    s = s._replace(
        fast_commits=s.fast_commits + (g_rd & (rd_state == SUB_LOCAL_COMMIT)).to(I32)
    )
    # dispatch command reaches DS d_ev
    arrival = ev_base + _delay(s, tau_ev, _salt(s, 41))
    first_t_ev, fast_ev = _tiga_arrival(s.dyn, s.clock_skew_us, now, arrival)
    disp_mask = (
        (row(s.op_state).to(I32) == OP_PENDING)
        & (row(s.op_ds).to(torch.int64) == c1(d_ev))
        & (row(s.op_round) == c1(row(s.cur_round)))
    )
    disp_first = disp_mask.to(I32).argmax(1)
    disp_has = disp_mask.any(1)
    s = s._replace(
        op_state=put_row(
            s.op_state,
            w(c1(is_sched) & disp_mask, w(kk == c1(disp_first), OP_ENROUTE, OP_QUEUED),
              row(s.op_state).to(I32)),
        )
    )
    s = s._replace(
        op_time=put_at(
            s.op_time, disp_first,
            w(is_sched & disp_has, first_t_ev, s.op_time[bidx, t, disp_first]),
        )
    )
    sub_row = w(c1(is_sched) & at_ev, SUB_RUN, sub_row)
    sub_tm = w(c1(is_sched) & at_ev, INF_US, sub_tm)
    s = s._replace(
        sub_arrive=put_at(s.sub_arrive, d_ev, w(is_sched, arrival, s.sub_arrive[bidx, t, d_ev])),
        sub_fast=put_at(s.sub_fast, d_ev, w(is_sched, fast_ev, s.sub_fast[bidx, t, d_ev])),
    )
    # DS-side 2PC legs
    sub_row = w(c1(is_prep_cmd) & at_ev, SUB_PREPARING, sub_row)
    sub_tm = w(c1(is_prep_cmd) & at_ev, c1(now + s.dyn.log_flush_us), sub_tm)
    vote_send_t = ev_base + _delay(s, tau_ev, _salt(s, 43))
    sub_row = w(c1(is_prepared) & at_ev, SUB_VOTE, sub_row)
    sub_tm = w(c1(is_prepared) & at_ev, c1(vote_send_t), sub_tm)
    # DM fan-ins: shared EWMA monitor refresh, frozen on a crashed DS; with
    # a schedule it samples the effective link (a degrade is observed) and
    # freezes on replica-link fan-ins too
    if F:
        mon_sample = s.tau_mw_eff[bidx, d_ev]
        mon_freeze = s.ds_down[bidx, d_ev] | s.on_repl[bidx, t, d_ev]
    else:
        mon_sample, mon_freeze = tau_ev, s.ds_down[bidx, d_ev]
    est_ev = s.tau_est[bidx, d_ev]
    s = s._replace(
        tau_est=s.tau_est.index_put(
            (bidx, d_ev),
            w((is_round_in | is_fin_ack) & ~mon_freeze,
              ewma_update(est_ev, mon_sample, cfg.beta_milli), est_ev),
        )
    )
    sub_row = w(c1(is_round_in) & at_ev, c1(w(is_reply, SUB_ROUND_AT_DM, SUB_VOTED)), sub_row)
    sub_tm = w(c1(is_round_in) & at_ev, INF_US, sub_tm)
    rd_done_row = rd_done_row | (c1(is_round_in) & at_ev)
    ack_committed = is_ack
    sub_row = w(c1(is_fin_ack) & at_ev, c1(w(ack_committed, SUB_DONE, SUB_ABORTED)), sub_row)
    sub_tm = w(c1(is_fin_ack) & at_ev, INF_US, sub_tm)
    # DS finish: ack back to the DM (release/grant + hotspot below)
    fl_ev = s.first_lock[bidx, t, d_ev]
    lcs_gate = is_commit_fin & (fl_ev < INF_US) & _measuring(cfg, s)
    lcs_span = w(lcs_gate, (now - fl_ev + 500) // 1000, 0)
    ack_salt = _salt(s, 47) + w(is_commit_fin, 0, 6)  # 47 commit, 53 abort
    ack_send_t = ev_base + _delay(s, tau_ev, ack_salt)
    sub_row = w(c1(is_finish) & at_ev, c1(w(is_commit_fin, SUB_ACK, SUB_ABORT_ACK)), sub_row)
    sub_tm = w(c1(is_finish) & at_ev, c1(ack_send_t), sub_tm)
    # timeout abort fan-out (peer notify + own ack)
    abort_family = (
        (sub_row == SUB_ABORT_PEER) | (sub_row == SUB_ABORT_ACK) | (sub_row == SUB_ABORTED)
    )
    peers = inv_t & (dd != c1(d_o)) & ~abort_family
    ab_salts = c1(_salt(s, 17)) + dd32
    jit = c1(s.jitter_milli)
    dd_b = dd.expand(B, D)
    if F:
        # abort notifications ride the effective links
        mesh_base, mesh_tau = _ds_send(s, d_o, dd_b, c1(now))
        notify_direct = mesh_base + _delay_salted(jit, mesh_tau, ab_salts)
        to_dm = do_base + _delay(s, tau_do, _salt(s, 19))
        dn_base, dn_tau = _mw_link(s, row(s.on_repl), dd_b, c1(to_dm))
        notify_via_dm = dn_base + _delay_salted(jit, dn_tau, ab_salts)
        notify = w(c1(s.dyn.early_abort), notify_direct, notify_via_dm)
        own_ack_t = do_base + _delay(s, tau_do, _salt(s, 23))
    else:
        notify_direct = _delay_salted(jit, s.tau_ds[bidx, d_o], ab_salts)
        to_dm = _delay(s, tau_do, _salt(s, 19))
        notify_via_dm = c1(to_dm) + _delay_salted(jit, s.tau_true, ab_salts)
        notify = c1(now) + w(c1(s.dyn.early_abort), notify_direct, notify_via_dm)
        own_ack_t = now + _delay(s, tau_do, _salt(s, 23))
    sub_row = w(c1(is_timeout) & peers, SUB_ABORT_PEER, sub_row)
    sub_tm = w(c1(is_timeout) & peers, notify, sub_tm)
    sub_row = w(c1(is_timeout) & at_do, SUB_ABORT_ACK, sub_row)
    sub_tm = w(c1(is_timeout) & at_do, c1(own_ack_t), sub_tm)
    ac_t = row(s.abort_cause)
    s = s._replace(
        abort_cause=put_row(
            s.abort_cause, w(is_timeout & (ac_t == CAUSE_NONE), CAUSE_TIMEOUT, ac_t)
        )
    )

    # ================== DM progress (round fan-in only) ======================
    waiting_c = inv_t & (sub_row == SUB_CHILLER_WAIT)
    active_c = inv_t & ~waiting_c
    ready_chiller = (
        is_round_in
        & (~active_c | (sub_row == SUB_VOTED)).all(1)
        & waiting_c.any(1)
        & s.dyn.chiller_two_stage
    )
    sub_row = w(c1(ready_chiller) & waiting_c, SUB_SCHED, sub_row)
    sub_tm = w(c1(ready_chiller) & waiting_c, c1(now), sub_tm)
    row_nn2 = row(s.op_state) != OP_NONE
    op_ds_t = row(s.op_ds).to(torch.int64)
    op_round_t = row(s.op_round)
    cur_round_t = row(s.cur_round)
    oh_row = op_ds_t[..., None] == dd  # [B, K, D]
    inv_rd = (oh_row & (row_nn2 & (op_round_t == c1(cur_round_t)))[..., None]).any(1)
    all_rd = (~inv_rd | rd_done_row).all(1)
    max_round = w(row_nn2, op_round_t.to(I32), -1).amax(1)
    final_t = cur_round_t.to(I32) >= max_round
    aborting_t = ph0 == T_ABORT_WAIT
    act = is_round_in & all_rd & ~aborting_t
    advance = act & ~final_t
    nxt_round = cur_round_t.to(I32) + 1
    s = s._replace(
        cur_round=put_row(s.cur_round, w(advance, nxt_round, cur_round_t.to(I32)))
    )
    rd_done_row = w(c1(advance), False, rd_done_row)
    inv_next = (oh_row & (row_nn2 & (op_round_t.to(I32) == c1(nxt_round)))[..., None]).any(1)
    # one shared stagger forecast (Eq.8 through the kernel): start OR advance
    inv0 = (oh_b & (valid_b & (rnd_b == 0))[..., None]).any(1)
    stag_mask = w(st, inv0, inv_next)
    off = _stagger(cfg, s, bidx, t, stag_mask)
    # chiller first-round split (start only)
    tmin = w(inv0, s.tau_est, INF_US).amin(1)
    stage1 = inv0 & (s.tau_est <= c1(tmin))
    stage2 = inv0 & ~stage1
    chil_state = w(stage2, SUB_CHILLER_WAIT, w(stage1, SUB_SCHED, SUB_NONE))
    chil_time = w(stage1, c1(now), INF_US)
    later = inv_new & ~inv0
    norm_state = w(inv0, SUB_SCHED, w(later, SUB_WAIT_ROUND, SUB_NONE))
    norm_time = w(inv0, c1(now) + off, INF_US)
    chl = c1(s.dyn.chiller_two_stage)
    sub_row = w(dsp, w(chl, chil_state, norm_state), sub_row)
    sub_tm = w(dsp, w(chl, chil_time, norm_time), sub_tm)
    sub_row = w(c1(advance) & inv_next, SUB_SCHED, sub_row)
    sub_tm = w(c1(advance) & inv_next, c1(now) + off, sub_tm)
    # commit decision (commit > prepare > log-flush priority)
    all_at_dm = (~inv_t | (sub_row == SUB_ROUND_AT_DM)).all(1)
    all_voted = (~inv_t | (sub_row == SUB_VOTED)).all(1)
    dec_c, dec_p, dec_l = sched.commit_decision(
        s.dyn.prepare, all_at_dm, all_voted, centralized,
        PREPARE_NONE, PREPARE_COORD, PREPARE_DECENTRAL,
    )
    gate_dec = act & final_t
    send_c = gate_dec & dec_c
    send_p = gate_dec & dec_p & ~dec_c
    log_f = gate_dec & dec_l & ~dec_c & ~dec_p
    salts = lambda a: c1(_salt(s, a)) + dd32
    dm_base, dm_tau = _mw_link(s, row(s.on_repl), dd_b, c1(now))
    dm_send = lambda a: dm_base + _delay_salted(jit, dm_tau, salts(a))
    sub_row = w(c1(send_c) & inv_t, SUB_COMMIT_CMD, sub_row)
    sub_tm = w(c1(send_c) & inv_t, dm_send(11), sub_tm)
    sub_row = w(c1(send_p) & inv_t, SUB_PREP_CMD, sub_row)
    sub_tm = w(c1(send_p) & inv_t, dm_send(13), sub_tm)
    # terminal commit-log flush fires: broadcast commit to every DS
    sub_row = w(c1(is_logflush) & inv_t, SUB_COMMIT_CMD, sub_row)
    sub_tm = w(c1(is_logflush) & inv_t, dm_send(31), sub_tm)

    # ============== shared release/grant + hotspot completion ================
    rel_gate = is_finish | is_timeout
    d_rel = w(is_finish, d_ev, d_o)
    hs_mask = row_nn2 & (op_ds_t == c1(d_rel)) & c1(rel_gate)
    hs = s.hs
    slot_f, found_f = hs_mod.lookup_slots(hs.slot_key, row(s.op_key), hs_mask)
    lel_f = (s.sub_lel[bidx, t, d_rel] + w(is_timeout, span_do, 0)).to(torch.float32)
    new_w = hs_mod.eq4_masked_w(hs.w_lat, slot_f, found_f, c1(lel_f), cfg.alpha_milli)
    upd_f = found_f.to(I32)
    hs = hs._replace(
        w_lat=hs.w_lat.scatter(1, slot_f, w(found_f, new_w, hs.w_lat.gather(1, slot_f))),
        a_cnt=torch.clamp_min(hs.a_cnt.scatter_add(1, slot_f, -upd_f), 0),
        t_cnt=hs.t_cnt.scatter_add(1, slot_f, upd_f),
        c_cnt=hs.c_cnt.scatter_add(1, slot_f, upd_f * c1(is_commit_fin).to(I32)),
    )
    s = s._replace(hs=hs)
    # release every lock txn t holds at d_rel + FIFO grants
    row_state2 = row(s.op_state).to(I32)
    mine = row_nn2 & (op_ds_t == c1(d_rel))
    held = mine & ((row_state2 == OP_EXEC) | (row_state2 == OP_HOLD)) & c1(rel_gate)
    rel_keys = w(held, row(s.op_key), -2)
    cancel_mask = mine & c1(rel_gate)
    s = s._replace(
        op_state=put_row(s.op_state, w(cancel_mask, OP_DONE, row_state2)),
        op_time=put_row(s.op_time, w(cancel_mask, INF_US, row(s.op_time))),
    )
    flat_state = s.op_state.reshape(B, -1).to(I32)
    flat_ds = s.op_ds.reshape(B, -1).to(torch.int64)
    granted = _grant_decision(
        held, rel_keys, flat_state, s.op_key.reshape(B, -1),
        s.op_write.reshape(B, -1), s.op_enq.reshape(B, -1),
    )
    exec_tg = c1(now) + _exec_us(cfg, s, flat_ds)
    s = s._replace(
        op_state=w(granted, OP_EXEC, flat_state).to(I8).reshape(B, T, K),
        op_time=w(granted, exec_tg, s.op_time.reshape(B, -1)).reshape(B, T, K),
    )
    gt = torch.arange(T * K, device=dev) // K
    g_idx = w(granted, gt * D + flat_ds, T * D)
    fl_pad = torch.cat(
        [s.first_lock.reshape(B, -1), torch.full((B, 1), INF_US, dtype=I32, device=dev)], 1
    )
    fl_pad = fl_pad.scatter_reduce(1, g_idx, w(granted, c1(now), INF_US), "amin")
    s = s._replace(first_lock=fl_pad[:, : T * D].reshape(B, T, D))

    # =================== terminal finish (ack fan-in / O3 abort) =============
    want = w(ack_committed, SUB_DONE, SUB_ABORTED)
    fin_done = is_fin_ack & (~inv_t | (sub_row == c1(want))).all(1)
    gate_fin = fin_done | force_abort
    committed_fin = fin_done & ack_committed
    lat = now - row(s.arrive)
    meas = _measuring(cfg, s)
    hbin = _hist_bin(lat)
    slot_n = (row(s.cur) % N).to(torch.int64)
    one_c = (gate_fin & meas & committed_fin).to(I32)
    one_a = (gate_fin & meas & ~committed_fin).to(I32)
    dist = row(s.is_dist)
    lat_ms = (lat + 500) // 1000
    retries_t = row(s.retries)
    will_retry_fin = ~committed_fin & (retries_t < s.dyn.max_retries)
    cause_fin = w(~will_retry_fin & (retries_t > 0), CAUSE_EXHAUSTED, row(s.abort_cause))
    # "during fault": some DS unreachable (crashed, or partitioned away)
    any_down_f = (_unreachable(s) if F else s.ds_down).any(1)

    def add_at(x, j, v):  # x [B, M] += v at column j, per lane
        return x.index_put((bidx, j), x[bidx, j] + v)

    n_slot = s.slot_commits.shape[-1]
    in_slot = slot_n < n_slot  # the reference's mode="drop" adds
    j_slot = w(in_slot, slot_n, 0)

    def add_slot(x, v):
        return x.index_put((bidx, t, j_slot), x[bidx, t, j_slot] + w(in_slot, v, 0))

    s = s._replace(
        ab_cause=add_at(s.ab_cause, cause_fin.to(torch.int64), one_a),
        commits_fault=s.commits_fault + w(any_down_f, one_c, 0),
        commits=s.commits + one_c,
        aborts=s.aborts + one_a,
        commits_dist=s.commits_dist + w(dist, one_c, 0),
        aborts_dist=s.aborts_dist + w(dist, one_a, 0),
        lat_sum=s.lat_sum + one_c * lat_ms,
        lat_sum_dist=s.lat_sum_dist + w(dist, one_c, 0) * lat_ms,
        hist_all=add_at(s.hist_all, hbin, one_c),
        hist_cen=add_at(s.hist_cen, hbin, w(dist, 0, one_c)),
        hist_dist=add_at(s.hist_dist, hbin, w(dist, one_c, 0)),
        slot_commits=add_slot(s.slot_commits, one_c),
        slot_aborts=add_slot(s.slot_aborts, one_a),
        slot_lat=add_slot(s.slot_lat, one_c * lat_ms),
    )
    # per-txn row resets
    gf = c1(gate_fin)
    sub_row = w(gf, SUB_NONE, sub_row)
    sub_tm = w(gf, INF_US, sub_tm)
    sub_lel_row = w(gf, 0, sub_lel_row)
    rd_done_row = w(gf, False, rd_done_row)
    retry = gate_fin & ~committed_fin & (retries_t < s.dyn.max_retries)
    base = s.dyn.retry_backoff_us
    h = _hash_u32(row(s.txn_ctr) * 977 + t.to(I32) * 131 + retries_t)
    jit_b = (h % torch.clamp_min(base, 1).to(torch.int64)).to(I32)
    backoff = torch.clamp_min(base * (1 + torch.clamp_max(retries_t, 7)) + jit_b, 1)
    s = s._replace(
        op_state=put_row(s.op_state, w(gf, OP_NONE, row(s.op_state).to(I32))),
        op_time=put_row(s.op_time, w(gf, INF_US, row(s.op_time))),
        inv=put_row(s.inv, w(gf, False, row(s.inv))),
        first_lock=put_row(s.first_lock, w(gf, INF_US, row(s.first_lock))),
        cur_round=put_row(s.cur_round, w(gate_fin, 0, row(s.cur_round).to(I32))),
        retries=put_row(s.retries, w(gate_fin, w(retry, retries_t + 1, 0), retries_t)),
        retry_same=put_row(s.retry_same, w(gate_fin, retry, row(s.retry_same))),
        blocked=put_row(s.blocked, w(gate_fin, 0, row(s.blocked))),
        cur=put_row(s.cur, row(s.cur) + (gate_fin & ~retry).to(I32)),
        abort_cause=put_row(s.abort_cause, w(gate_fin, CAUSE_NONE, row(s.abort_cause))),
    )

    # ======================= phase / terminal timer ==========================
    phase = ph0
    phase = w(dispatching, T_ACTIVE, phase)
    phase = w(is_logflush | send_c, T_COMMIT_WAIT, phase)
    phase = w(log_f, T_COMMIT_LOG, phase)
    phase = w(is_timeout, T_ABORT_WAIT, phase)
    phase = w(gate_fin, T_IDLE, phase)
    tt = row(s.term_time)
    tt = w(block, now + s.dyn.admission_backoff_us, tt)
    tt = w(dispatching | is_logflush | send_c | is_timeout, INF_US, tt)
    tt = w(log_f, now + s.dyn.log_flush_us, tt)
    tt = w(gate_fin, w(committed_fin, now, now + backoff), tt)

    # ======================= scatter the event rows ==========================
    # receive-side WAN-leg charging (mirrors the reference)
    wan_inc = (
        is_arrive.to(I32) + is_round_in.to(I32) + is_prep_cmd.to(I32)
        + is_fin_ack.to(I32) + (is_sub & (sub0 == SUB_COMMIT_CMD)).to(I32)
        + (is_abort_fin & ~s.dyn.early_abort).to(I32)
    )
    s = s._replace(
        phase=put_row(s.phase, phase),
        term_time=put_row(s.term_time, tt),
        sub_state=put_row(s.sub_state, sub_row),
        sub_time=put_row(s.sub_time, sub_tm),
        sub_lel=put_row(s.sub_lel, sub_lel_row),
        rd_done=put_row(s.rd_done, rd_done_row),
        lcs_sum=s.lcs_sum + lcs_span,
        lcs_cnt=s.lcs_cnt + lcs_gate.to(I32),
        wan_legs=s.wan_legs + wan_inc,
    )

    # ============== replica failover bookkeeping (start / finish) ============
    # one on_repl write: a dispatching start routes the hit subtxns to their
    # replicas (stale reads and the staleness window recorded), a finish
    # releases the routing; after the scatter, so every send above read the
    # routing as it was
    if F:
        s = _failover_routing(s, t, now, fo, dispatching, gate_fin, valid_b, write_b, ds_b)

    # ============================== noop =====================================
    nz = is_noop[:, None, None]
    n1 = is_noop[:, None]
    upd = dict(
        op_time=w(nz & (s.op_time == now[:, None, None]), INF_US, s.op_time),
        sub_time=w(nz & (s.sub_time == now[:, None, None]), INF_US, s.sub_time),
        term_time=w(n1 & (s.term_time == c1(now)), INF_US, s.term_time),
        noops=s.noops + is_noop.to(I32),
    )
    if F:
        upd.update(
            fault_time=w(n1 & (s.fault_time == c1(now)), INF_US, s.fault_time),
            hb_time=w(n1 & (s.hb_time == c1(now)), INF_US, s.hb_time),
        )
    s = s._replace(**upd)

    # ===================== fault / heartbeat tail events =====================
    # dead last: the row-t scatters above rewrite row t (a stale row-0 copy
    # for a tail event) and would clobber the crash cascade's writes
    if F:
        s = _fault_event(cfg, s, f_ev, is_fault_ev)
        s = _hb_event(cfg, s, d_hb, is_hb_ev)
    return s
