"""Fused plan + omnibus windowed drain over B lockstep lanes (port of
`repro.core.engine.fused._omni_window`, the `SimConfig(lockstep=True,
drain=True)` step of the reference's vmap strategy).

ONE straight-line masked pass per step. The window plan
(`window._window_plan`) already computes, per event slot, what each
drainable handler would; a single event is the rank-0 singleton of the
same masked write pass (`apply._apply_window` with window-OR-single-event
masks). Only the *non-drainable* categories (txn start with admission and
the hot-table claim, lock-wait timeout with its abort fan-out, round
advance / chiller stage 2, txn-completing ack, release with queued
waiters, noop) have handlers of their own: identity-when-off row writes on
each lane's rank-0 event, `omni._omni_step`'s masked-delta style, with
their release footprint folded INTO the shared pass (`xcancel` / `xlel` /
`xcommit`) so the hotspot Eq.(4) update runs once a step.

The [B] lane axis is written out as in `omni.py`. Eq.(9) (admission) and
Eq.(8) (stagger) go through the `geo_schedule` kernel once each a step.
Bitwise-identical to `_omni_step` on every leaf but the drain telemetry
(`drained`, `windows`, `win_stops`, `fused`, `chained`). With a fault
schedule (`cfg.max_faults > 0`) the reference's `if F:` branches run too:
a due fault row is always pinned and fires through `faults._fault_event`
at the very end of the pass; a heartbeat probe drains inside a window, or
fires through `faults._hb_event` when no window forms.
"""

from __future__ import annotations

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core import scheduler as sched
from repro_torch.core.netmodel import INF_US, _hash_u32, ewma_update
from repro_torch.core.workloads import Bank
from repro_torch.core.engine.apply import _apply_window, _drainable_due
from repro_torch.core.engine.faults import (
    _failover_admission, _failover_routing, _fault_event, _hb_event, _tail_event,
)
from repro_torch.core.engine.handlers import _stagger
from repro_torch.core.engine.locks import _grant_decision
from repro_torch.core.engine.state import (
    OP_NONE, OP_PENDING, OP_ENROUTE, OP_WAIT, OP_EXEC, OP_HOLD,
    SUB_NONE, SUB_SCHED, SUB_ROUND_REPLY, SUB_ROUND_AT_DM, SUB_WAIT_ROUND,
    SUB_CHILLER_WAIT, SUB_VOTE, SUB_VOTED, SUB_COMMIT_CMD, SUB_ACK, SUB_LOCAL_COMMIT,
    SUB_DONE, SUB_ABORT_PEER, SUB_ABORT_ACK, SUB_ABORTED,
    T_IDLE, T_ACTIVE, T_COMMIT_LOG, T_ABORT_WAIT,
    CAUSE_NONE, CAUSE_TIMEOUT, CAUSE_ADMISSION, CAUSE_CRASH, CAUSE_EXHAUSTED,
    N_STOP_REASONS,
    _SALT_MUL,
    SimConfig,
    SimState,
    _delay_salted,
    _ds_send,
    _exec_us,
    _hist_bin,
    _mw_link,
    _times_flat,
    _u01,
)
from repro_torch.core.engine.window import _window_plan

I8 = torch.int8
I32 = torch.int32
I64 = torch.int64


def _omni_window(cfg: SimConfig, bank: Bank, s: SimState) -> SimState:
    """Every lane's planned window, or its rank-0 event, in ONE masked pass.

    Where a lane's window holds >= 2 events (and the `_drainable_due`
    pre-check agrees), the shared masked pass writes the whole window;
    otherwise it writes just the rank-0 event (the event `_omni_step` would
    pick), with the non-drainable handlers below as identity-when-off row
    writes. `bank` leaves carry a leading [B] axis."""
    T, D, K, N, F = cfg.terminals, cfg.num_ds, cfg.max_ops, cfg.bank_txns, cfg.max_faults
    M0 = T + T * D + T * K
    C = cfg.hot_capacity
    w = torch.where
    B = s.now.shape[0]
    dev = s.now.device
    bidx = torch.arange(B, device=dev)
    dd = torch.arange(D, device=dev)
    dd32 = dd.to(I32)
    c1 = lambda x: x[:, None]  # noqa: E731  [B] -> [B, 1]
    c2 = lambda x: x[:, None, None]  # noqa: E731  [B] -> [B, 1, 1]

    flat = _times_flat(s)
    v = _window_plan(cfg, bank, s)
    use = v.use & _drainable_due(s)

    # ---- rank-0 event: the plan's first candidate IS the lex-min event
    # `_omni_step` picks (same tie-break) ------------------------------------
    i0 = v.cand_i[:, 0]
    t_now0 = flat.gather(1, i0[:, None])[:, 0]
    is_term0 = i0 < T
    is_sub0 = ~is_term0 & (i0 < T + T * D)
    is_op0 = ~is_term0 & ~is_sub0
    j_sub = i0 - T
    j_op = i0 - T - T * D
    t = w(is_term0, i0, w(is_sub0, j_sub // D, j_op // K))
    idx = w(is_sub0, j_sub % D, w(is_term0, 0, j_op % K))
    if F:
        # fault tail events: always pinned (use False), handled at the very
        # end of the pass; a rank-0 heartbeat takes its handler only where
        # no window forms (`~use`), else it drains inside the window
        is_fault0, is_hb0, f_ev0, d_hb0 = _tail_event(i0, M0, F, D)
        is_tail0 = is_fault0 | is_hb0
        is_op0 = is_op0 & ~is_tail0
        t = w(is_tail0, 0, t)
        idx = w(is_tail0, 0, idx)
    k_ev = idx.clamp(max=K - 1)
    d_ev = idx.clamp(max=D - 1)
    it0 = s.iters + 1

    def salt0(a):
        return it0 * _SALT_MUL + a

    oh_t = torch.arange(T, device=dev) == c1(t)  # [B,T]

    def row(x):  # lane b's row t: [B, ...]
        return x[bidx, t]

    def put_row(x, val):
        return x.index_put((bidx, t), val.to(x.dtype))

    # ---- single-event category flags (all False where a window applies) ---
    sub0 = s.sub_state[bidx, t, d_ev].to(I32)
    op0 = s.op_state[bidx, t, k_ev].to(I32)
    ph0 = row(s.phase).to(I32)
    single = ~use
    is_start = single & is_term0 & (ph0 == T_IDLE)
    is_timeout = single & is_op0 & (op0 == OP_WAIT)
    # pinned sub events take the handlers below; drainable ones (a
    # one-event window included) go through the shared pass
    pin0 = v.pinned_sub[bidx, t, d_ev]
    is_fanin_x = single & is_sub0 & v.dm_cat[bidx, t, d_ev] & pin0
    is_finish_x = single & is_sub0 & v.f_cat[bidx, t, d_ev] & pin0  # waiter release
    is_reply0 = sub0 == SUB_ROUND_REPLY
    is_round_in_x = is_fanin_x & (is_reply0 | (sub0 == SUB_VOTE))
    is_ack0 = sub0 == SUB_ACK
    is_fin_ack_x = is_fanin_x & (is_ack0 | (sub0 == SUB_ABORT_ACK))
    is_commit_fin0 = (sub0 == SUB_COMMIT_CMD) | (sub0 == SUB_LOCAL_COMMIT)
    sub_known = v.dm_cat | v.f_cat | v.cat_sched | v.cat_prep | v.cat_preparing
    is_noop = single & ~(
        (is_term0 & ((ph0 == T_IDLE) | (ph0 == T_COMMIT_LOG)))
        | (is_op0 & ((op0 == OP_ENROUTE) | (op0 == OP_WAIT) | (op0 == OP_EXEC)))
        | (is_sub0 & sub_known[bidx, t, d_ev])
    )
    if F:
        is_noop = is_noop & ~is_tail0

    # ---- shared masked pass: the window, or the rank-0 drainable event ----
    act_term = w(c1(use), v.win_term, (v.pos_term == 0) & ~v.pinned_term)
    act_sub = w(c2(use), v.win_sub, (v.pos_sub == 0) & ~v.pinned_sub)
    act_op = w(c2(use), v.win_op, (v.pos_op == 0) & ~v.pinned_op)
    # the pinned single event's release footprint, folded into the shared
    # pass so the hotspot update runs once a step
    d_o = s.op_ds[bidx, t, k_ev].to(I64)
    d_rel = w(is_finish_x, d_ev, d_o)
    rel_gate_x = is_finish_x | is_timeout
    opn = s.op_state != OP_NONE
    xcancel = c2(rel_gate_x) & oh_t[..., None] & opn & (s.op_ds.to(I64) == c2(d_rel))
    span_do = torch.clamp_min(t_now0 - s.sub_arrive[bidx, t, d_o], 0)
    oh_t_do = oh_t[..., None] & (dd == c1(d_o))[:, None, :]
    xlel = w(oh_t_do & c2(is_timeout), c2(span_do), 0)
    oh_t_dev = oh_t[..., None] & (dd == c1(d_ev))[:, None, :]
    xcommit = oh_t_dev & c2(is_finish_x & is_commit_fin0)
    stop_oh = (c1(v.stop_code) == torch.arange(N_STOP_REASONS, device=dev)).to(I32)
    sx = _apply_window(
        cfg, s, v, act_term, act_sub, act_op,
        w(use, v.t_last, t_now0),
        w(use, v.n_win, 1),
        w(use, v.n_win, 0),
        use.to(I32),
        w(c1(use), stop_oh, 0),
        fused_inc=1,
        xcancel=xcancel,
        xlel=xlel,
        xcommit=xcommit,
        xrel=(rel_gate_x, t, d_rel),
        act_hb=w(c1(use), v.win_hb, False),
        chained_inc=w(use, v.n_chained, 0),
        act_fu=v.fu_win & c2(use),
        act_pfu=v.pfu_win & c1(use),
    )

    # ======================================================================
    # Non-drainable single-event handlers on each lane's rank-0 event; every
    # write is identity-valued where `use`.
    # ======================================================================

    # ---- latency-monitor refresh for the pinned fan-in (drainable fan-ins
    # were counted by the shared pass's EWMA chain) -------------------------
    # (frozen on a crashed DS; with a schedule also on a replica-served
    # one, and the sample is the effective RTT: a degrade is observed)
    if F:
        mon_freeze = s.ds_down[bidx, d_ev] | s.on_repl[bidx, t, d_ev]
        mon_sample = sx.tau_mw_eff[bidx, d_ev]
    else:
        mon_freeze, mon_sample = s.ds_down[bidx, d_ev], sx.tau_true[bidx, d_ev]
    est_ev = sx.tau_est[bidx, d_ev]
    sx = sx._replace(tau_est=sx.tau_est.index_put(
        (bidx, d_ev),
        w(is_fanin_x & ~mon_freeze, ewma_update(est_ev, mon_sample, cfg.beta_milli), est_ev),
    ))

    # =================== txn start: bank load + admission ==================
    slot_b = (row(s.cur) % N).to(I64)
    key_b = bank.key[bidx, t, slot_b]
    write_b = bank.write[bidx, t, slot_b]
    ds_b = bank.ds[bidx, t, slot_b]
    rnd_b = bank.round_id[bidx, t, slot_b]
    valid_b = bank.valid[bidx, t, slot_b]
    oh_b = ds_b.to(I64)[..., None] == dd  # [B,K,D]
    inv_new = (oh_b & valid_b[..., None]).any(1)
    st = c1(is_start)
    sx = sx._replace(
        op_key=put_row(sx.op_key, w(st, w(valid_b, key_b, -1), row(sx.op_key))),
        op_write=put_row(sx.op_write, w(st, write_b, row(sx.op_write))),
        op_ds=put_row(sx.op_ds, w(st, ds_b, row(sx.op_ds))),
        op_round=put_row(sx.op_round, w(st, rnd_b, row(sx.op_round))),
        op_state=put_row(
            sx.op_state, w(st, w(valid_b, OP_PENDING, OP_NONE), row(sx.op_state).to(I32))
        ),
        op_time=put_row(sx.op_time, w(st, INF_US, row(sx.op_time))),
        inv=put_row(sx.inv, w(st, inv_new, row(sx.inv))),
        is_dist=put_row(sx.is_dist, w(is_start, inv_new.to(I32).sum(1) > 1, row(sx.is_dist))),
        cur_round=put_row(sx.cur_round, w(is_start, 0, row(sx.cur_round).to(I32))),
        first_lock=put_row(sx.first_lock, w(st, INF_US, row(sx.first_lock))),
        txn_ctr=put_row(sx.txn_ctr, row(sx.txn_ctr) + is_start.to(I32)),
    )

    # O3 admission (Eq.9 through the kernel), read on the pre-claim table
    hs = sx.hs
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
    u = _u01(salt0(29) + t.to(I32))
    block, force_abort = sched.admission_decision(
        p_abort, u, row(s.blocked), s.dyn.max_blocked
    )
    if F:
        hit_v, fo = _failover_admission(s, inv_new, oh_b, valid_b, write_b, t_now0)
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
    zval = lambda f: w(dsp, 0, f.gather(1, ztgt))  # noqa: E731
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
    sx = sx._replace(
        hs=hs,
        arrive=put_row(sx.arrive, w(dispatching | force_abort, t_now0, row(sx.arrive))),
        blocked=put_row(sx.blocked, row(sx.blocked) + block.to(I32)),
        abort_cause=put_row(
            sx.abort_cause,
            w(force_abort, w(hit_down, CAUSE_CRASH, CAUSE_ADMISSION), row(sx.abort_cause)),
        ),
    )
    inv_t = row(sx.inv)

    # ===================== subtxn row (ordered masked writes) ==============
    sub_row = row(sx.sub_state).to(I32)
    sub_tm = row(sx.sub_time)
    rd_done_row = row(sx.rd_done)
    sub_lel_row = row(sx.sub_lel)
    at_ev = dd == c1(d_ev)
    at_do = dd == c1(d_o)
    rd_done_row = w(st, False, rd_done_row)
    sub_lel_row = w(st, 0, sub_lel_row)
    # pinned fan-in self-update (drainable fan-ins took the shared pass)
    ri = c1(is_round_in_x) & at_ev
    sub_row = w(ri, c1(w(is_reply0, SUB_ROUND_AT_DM, SUB_VOTED)), sub_row)
    sub_tm = w(ri, INF_US, sub_tm)
    rd_done_row = rd_done_row | ri
    fa_ev = c1(is_fin_ack_x) & at_ev
    sub_row = w(fa_ev, c1(w(is_ack0, SUB_DONE, SUB_ABORTED)), sub_row)
    sub_tm = w(fa_ev, INF_US, sub_tm)
    # waiter-release finish: ack back to the DM (the release itself was
    # folded into the shared pass; the FIFO grants run below)
    fl_ev = s.first_lock[bidx, t, d_ev]
    lcs_gate_x = (is_finish_x & is_commit_fin0 & (fl_ev < INF_US)
                  & (t_now0 >= cfg.warmup_us))
    lcs_span_x = w(lcs_gate_x, (t_now0 - fl_ev + 500) // 1000, 0)
    ack_salt = salt0(47) + w(is_commit_fin0, 0, 6)  # 47 commit, 53 abort
    kb0, kr0 = _mw_link(s, s.on_repl[bidx, t, d_ev], d_ev, t_now0)
    ack_send_t = kb0 + _delay_salted(s.jitter_milli, kr0, ack_salt)
    fin_ev = c1(is_finish_x) & at_ev
    sub_row = w(fin_ev, c1(w(is_commit_fin0, SUB_ACK, SUB_ABORT_ACK)), sub_row)
    sub_tm = w(fin_ev, c1(ack_send_t), sub_tm)
    # timeout abort fan-out (peer notify + own ack); the partial round's LEL
    # was folded into the shared pass's Eq.(4) read, accounted here
    abort_family = (
        (sub_row == SUB_ABORT_PEER) | (sub_row == SUB_ABORT_ACK) | (sub_row == SUB_ABORTED)
    )
    peers = inv_t & (dd != c1(d_o)) & ~abort_family
    ab_salts = c1(salt0(17)) + dd32
    jit = c1(s.jitter_milli)
    if F:
        # abort notifications ride the effective links
        dd_b = dd.expand(B, D)
        mesh_base, mesh_tau = _ds_send(s, d_o, dd_b, c1(t_now0))
        notify_direct = mesh_base + _delay_salted(jit, mesh_tau, ab_salts)
        up_base, up_tau = _mw_link(s, s.on_repl[bidx, t, d_o], d_o, t_now0)
        to_dm = up_base + _delay_salted(s.jitter_milli, up_tau, salt0(19))
        dn_base, dn_tau = _mw_link(s, row(s.on_repl), dd_b, c1(to_dm))
        notify_via_dm = dn_base + _delay_salted(jit, dn_tau, ab_salts)
        notify = w(c1(s.dyn.early_abort), notify_direct, notify_via_dm)
        own_ack_t = up_base + _delay_salted(s.jitter_milli, up_tau, salt0(23))
    else:
        tau_do = s.tau_true[bidx, d_o]
        notify_direct = _delay_salted(jit, s.tau_ds[bidx, d_o], ab_salts)
        to_dm = _delay_salted(s.jitter_milli, tau_do, salt0(19))
        notify_via_dm = c1(to_dm) + _delay_salted(jit, s.tau_true, ab_salts)
        notify = c1(t_now0) + w(c1(s.dyn.early_abort), notify_direct, notify_via_dm)
        own_ack_t = t_now0 + _delay_salted(s.jitter_milli, tau_do, salt0(23))
    sub_row = w(c1(is_timeout) & peers, SUB_ABORT_PEER, sub_row)
    sub_tm = w(c1(is_timeout) & peers, notify, sub_tm)
    sub_row = w(c1(is_timeout) & at_do, SUB_ABORT_ACK, sub_row)
    sub_tm = w(c1(is_timeout) & at_do, c1(own_ack_t), sub_tm)
    j_lel = w(is_timeout, d_o, 0)
    sub_lel_row = sub_lel_row.index_put(
        (bidx, j_lel), sub_lel_row[bidx, j_lel] + w(is_timeout, span_do, 0)
    )
    ac_t = row(sx.abort_cause)  # first cause wins
    sx = sx._replace(abort_cause=put_row(
        sx.abort_cause, w(is_timeout & (ac_t == CAUSE_NONE), CAUSE_TIMEOUT, ac_t)
    ))

    # ============== pinned DM progress: chiller stage-2 / advance ==========
    ready_ch = is_round_in_x & v.ready_chiller_j[bidx, t, d_ev]
    waiting_c = inv_t & (sub_row == SUB_CHILLER_WAIT)
    sub_row = w(c1(ready_ch) & waiting_c, SUB_SCHED, sub_row)
    sub_tm = w(c1(ready_ch) & waiting_c, c1(t_now0), sub_tm)
    advance = is_round_in_x & v.advance_j[bidx, t, d_ev]
    nxt_round = row(s.cur_round).to(I32) + 1
    sx = sx._replace(
        cur_round=put_row(sx.cur_round, w(advance, nxt_round, row(sx.cur_round).to(I32)))
    )
    rd_done_row = w(c1(advance), False, rd_done_row)
    row_st = row(s.op_state).to(I32)
    row_nn2 = row_st != OP_NONE
    op_ds_t = row(s.op_ds).to(I64)
    oh_row = op_ds_t[..., None] == dd  # [B,K,D]
    inv_next = (oh_row & (row_nn2 & (row(s.op_round).to(I32) == c1(nxt_round)))[..., None]).any(1)
    # one shared stagger forecast (Eq.8 through the kernel): start OR advance
    inv0 = (oh_b & (valid_b & (rnd_b == 0))[..., None]).any(1)
    off = _stagger(cfg, sx, bidx, t, w(st, inv0, inv_next))
    # chiller first-round split (start only)
    tmin = w(inv0, sx.tau_est, INF_US).amin(1)
    stage1 = inv0 & (sx.tau_est <= c1(tmin))
    stage2 = inv0 & ~stage1
    chil_state = w(stage2, SUB_CHILLER_WAIT, w(stage1, SUB_SCHED, SUB_NONE))
    chil_time = w(stage1, c1(t_now0), INF_US)
    later = inv_new & ~inv0
    norm_state = w(inv0, SUB_SCHED, w(later, SUB_WAIT_ROUND, SUB_NONE))
    norm_time = w(inv0, c1(t_now0) + off, INF_US)
    chl = c1(s.dyn.chiller_two_stage)
    sub_row = w(dsp, w(chl, chil_state, norm_state), sub_row)
    sub_tm = w(dsp, w(chl, chil_time, norm_time), sub_tm)
    sub_row = w(c1(advance) & inv_next, SUB_SCHED, sub_row)
    sub_tm = w(c1(advance) & inv_next, c1(t_now0) + off, sub_tm)

    # ============== FIFO grants after the folded waiter release ============
    # (the cancel/hotspot half ran inside the shared pass via xcancel; the
    # grants read the post-cancel table, as the sequential handler does)
    held = (row_nn2 & (op_ds_t == c1(d_rel)) & ((row_st == OP_EXEC) | (row_st == OP_HOLD))
            & c1(rel_gate_x))
    rel_keys = w(held, row(s.op_key), -2)
    flat_state = sx.op_state.reshape(B, -1).to(I32)
    granted = _grant_decision(
        held, rel_keys, flat_state, sx.op_key.reshape(B, -1),
        sx.op_write.reshape(B, -1), sx.op_enq.reshape(B, -1),
    )
    exec_tg = c1(t_now0) + _exec_us(cfg, s, sx.op_ds.reshape(B, -1).to(I64))
    sx = sx._replace(
        op_state=w(granted, OP_EXEC, flat_state).to(I8).reshape(B, T, K),
        op_time=w(granted, exec_tg, sx.op_time.reshape(B, -1)).reshape(B, T, K),
    )
    # grant-time first_lock as an elementwise group-min over the op rows
    oh_g = sx.op_ds.to(I64)[..., None] == dd  # [B,T,K,D]
    g_min = w(granted.reshape(B, T, K)[..., None] & oh_g, t_now0[:, None, None, None],
              INF_US).amin(2)
    sx = sx._replace(first_lock=torch.minimum(sx.first_lock, g_min))

    # =================== terminal finish (ack fan-in / O3 abort) ===========
    fin_done = is_fin_ack_x & (v.done_ack_j[bidx, t, d_ev] | v.done_abk_j[bidx, t, d_ev])
    gate_fin = fin_done | force_abort
    committed_fin = fin_done & is_ack0
    lat = t_now0 - row(sx.arrive)
    meas = t_now0 >= cfg.warmup_us
    hbin = _hist_bin(lat)
    slot_n = (row(s.cur) % N).to(I64)
    one_c = (gate_fin & meas & committed_fin).to(I32)
    one_a = (gate_fin & meas & ~committed_fin).to(I32)
    dist = row(sx.is_dist)
    lat_ms = (lat + 500) // 1000
    retries_t = row(sx.retries)
    will_retry_fin = ~committed_fin & (retries_t < s.dyn.max_retries)
    cause_fin = w(~will_retry_fin & (retries_t > 0), CAUSE_EXHAUSTED, row(sx.abort_cause))

    # "during fault": some DS unreachable (crashed, or partitioned away)
    any_down_f = (s.ds_down | (s.mw_heal > c1(t_now0)) if F else s.ds_down).any(1)

    def add_at(x, j, val):  # x [B, M] += val at column j, per lane
        return x.index_put((bidx, j), x[bidx, j] + val)

    in_slot = slot_n < sx.slot_commits.shape[-1]  # the reference's mode="drop" adds
    j_slot = w(in_slot, slot_n, 0)

    def add_slot(x, val):
        return x.index_put((bidx, t, j_slot), x[bidx, t, j_slot] + w(in_slot, val, 0))

    sx = sx._replace(
        ab_cause=add_at(sx.ab_cause, cause_fin.to(I64), one_a),
        commits_fault=sx.commits_fault + w(any_down_f, one_c, 0),
        commits=sx.commits + one_c,
        aborts=sx.aborts + one_a,
        commits_dist=sx.commits_dist + w(dist, one_c, 0),
        aborts_dist=sx.aborts_dist + w(dist, one_a, 0),
        lat_sum=sx.lat_sum + one_c * lat_ms,
        lat_sum_dist=sx.lat_sum_dist + w(dist, one_c, 0) * lat_ms,
        hist_all=add_at(sx.hist_all, hbin, one_c),
        hist_cen=add_at(sx.hist_cen, hbin, w(dist, 0, one_c)),
        hist_dist=add_at(sx.hist_dist, hbin, w(dist, one_c, 0)),
        slot_commits=add_slot(sx.slot_commits, one_c),
        slot_aborts=add_slot(sx.slot_aborts, one_a),
        slot_lat=add_slot(sx.slot_lat, one_c * lat_ms),
    )
    # per-txn row resets
    gf = c1(gate_fin)
    sub_row = w(gf, SUB_NONE, sub_row)
    sub_tm = w(gf, INF_US, sub_tm)
    sub_lel_row = w(gf, 0, sub_lel_row)
    rd_done_row = w(gf, False, rd_done_row)
    retry = gate_fin & ~committed_fin & (retries_t < s.dyn.max_retries)
    base = s.dyn.retry_backoff_us
    h = _hash_u32(row(sx.txn_ctr) * 977 + t.to(I32) * 131 + retries_t)
    jit_b = (h % torch.clamp_min(base, 1).to(I64)).to(I32)
    # floored at 1 us so a zero-backoff retry cannot livelock the loop
    backoff = torch.clamp_min(base * (1 + torch.clamp_max(retries_t, 7)) + jit_b, 1)
    sx = sx._replace(
        op_state=put_row(sx.op_state, w(gf, OP_NONE, row(sx.op_state).to(I32))),
        op_time=put_row(sx.op_time, w(gf, INF_US, row(sx.op_time))),
        inv=put_row(sx.inv, w(gf, False, row(sx.inv))),
        first_lock=put_row(sx.first_lock, w(gf, INF_US, row(sx.first_lock))),
        cur_round=put_row(sx.cur_round, w(gate_fin, 0, row(sx.cur_round).to(I32))),
        retries=put_row(sx.retries, w(gate_fin, w(retry, retries_t + 1, 0), retries_t)),
        retry_same=put_row(sx.retry_same, w(gate_fin, retry, row(sx.retry_same))),
        blocked=put_row(sx.blocked, w(gate_fin, 0, row(sx.blocked))),
        cur=put_row(sx.cur, row(sx.cur) + (gate_fin & ~retry).to(I32)),
        abort_cause=put_row(sx.abort_cause, w(gate_fin, CAUSE_NONE, row(sx.abort_cause))),
    )

    # ======================= phase / terminal timer ========================
    # (the drainable gates — log flush, send-commit, log decision — were
    # written by the shared pass; only the pinned single-event gates remain)
    phase = row(sx.phase).to(I32)
    phase = w(dispatching, T_ACTIVE, phase)
    phase = w(is_timeout, T_ABORT_WAIT, phase)
    phase = w(gate_fin, T_IDLE, phase)
    tt = row(sx.term_time)
    tt = w(block, t_now0 + s.dyn.admission_backoff_us, tt)
    tt = w(dispatching | is_timeout, INF_US, tt)
    tt = w(gate_fin, w(committed_fin, t_now0, t_now0 + backoff), tt)

    # ======================= scatter the event rows ========================
    # WAN legs of the pinned singleton routes (drainable events were charged
    # in the shared pass): a pinned fan-in is a WAN receive; a waiter-release
    # finish charges by its pre-state (COMMIT_CMD +1, LOCAL_COMMIT +0,
    # ABORT_PEER only via the DM route)
    wan_x = (
        is_fanin_x.to(I32)
        + (is_finish_x & (sub0 == SUB_COMMIT_CMD)).to(I32)
        + (is_finish_x & (sub0 == SUB_ABORT_PEER) & ~s.dyn.early_abort).to(I32)
    )
    sx = sx._replace(
        phase=put_row(sx.phase, phase),
        term_time=put_row(sx.term_time, tt),
        sub_state=put_row(sx.sub_state, sub_row),
        sub_time=put_row(sx.sub_time, sub_tm),
        sub_lel=put_row(sx.sub_lel, sub_lel_row),
        rd_done=put_row(sx.rd_done, rd_done_row),
        lcs_sum=sx.lcs_sum + lcs_span_x,
        lcs_cnt=sx.lcs_cnt + lcs_gate_x.to(I32),
        wan_legs=sx.wan_legs + wan_x,
    )

    # ============== replica failover bookkeeping (start / finish) ==========
    # one on_repl write: a dispatching start routes the hit subtxns to their
    # replicas (stale reads and the staleness window recorded), a finish
    # releases the routing; after the scatter, so every send above read the
    # routing as it was
    if F:
        sx = _failover_routing(sx, t, t_now0, fo, dispatching, gate_fin, valid_b, write_b, ds_b)

    # ============================== noop ===================================
    nz, n1 = c2(is_noop), c1(is_noop)
    upd = dict(
        op_time=w(nz & (sx.op_time == c2(t_now0)), INF_US, sx.op_time),
        sub_time=w(nz & (sx.sub_time == c2(t_now0)), INF_US, sx.sub_time),
        term_time=w(n1 & (sx.term_time == c1(t_now0)), INF_US, sx.term_time),
        noops=sx.noops + is_noop.to(I32),
    )
    if F:
        upd.update(
            fault_time=w(n1 & (sx.fault_time == c1(t_now0)), INF_US, sx.fault_time),
            hb_time=w(n1 & (sx.hb_time == c1(t_now0)), INF_US, sx.hb_time),
        )
    sx = sx._replace(**upd)

    # ===================== fault / heartbeat tail events ===================
    # dead last: the row-t scatters above rewrite row t (a stale row-0 copy
    # for a tail event) and would clobber the crash cascade's writes. A
    # rank-0 fault is always pinned (`use` False); a rank-0 heartbeat that
    # drained in the window was counted and re-armed by `_apply_window`
    if F:
        sx = _fault_event(cfg, sx, f_ev0, is_fault0)
        sx = _hb_event(cfg, sx, d_hb0, is_hb0 & ~use)
    return sx
