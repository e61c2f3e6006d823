"""Windowed conflict-free drain: plan the maximal prefix of the event order
(port of `repro.core.engine.window`, batched over lanes; it serves the
lockstep lanes and the sequential map lanes alike).

`_window_plan` ranks each lane's concatenated event-time view into the
exact sequential processing order and finds the longest conflict-free
prefix; `apply._apply_window` writes the whole window in one masked pass,
bitwise-identical to single-event stepping, and `fused._omni_window` runs
both in one branchless step. Window stoppers (slot-accurate read/write
sets, as the reference's module docstring lists them):

* non-drainable categories (txn start, lock-wait timeout, round advance,
  chiller stage-2 re-dispatch, txn-completing ack, release with a queued
  waiter) pin their earliest-scheduled-time to 0;
* an event scheduling work at/before the window's timestamps (running-min
  rule over earliest-scheduled-times), less the follow-ups the chain pass
  admits (`chain.py`);
* the second touch of one lock key (arrival / chain target / released
  footprint), via first-touch ranks over the candidates' touch list;
* the slot-accurate DM rules: a *triggering* fan-in writes its whole row
  and stays forward-exclusive, and a fan-in's row read is exact only when
  every earlier in-window event of its terminal is a non-triggering
  fan-in;
* more than `K_EWMA` fan-ins per data source;
* a release sharing its (terminal, DS) with an earlier op event.

Every windowed event keeps the iteration number (hash salt) and timestamp
it would have had sequentially, so a drained run is bitwise the `drain=False`
run on every leaf but the drain telemetry. With a fault schedule the
fault and heartbeat tail slots join the order: a due fault row is pinned
and stops the window at itself (stop reason `fault`); a heartbeat probe is
conflict-free and drains, its re-arm time entering the running-min rule.
"""

from __future__ import annotations

import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.netmodel import INF_US
from repro_torch.core.protocols import PREPARE_COORD, PREPARE_DECENTRAL, PREPARE_NONE
from repro_torch.core.workloads import Bank
from repro_torch.core.engine.chain import (
    CHAIN_DEPTH,
    MAXI,
    STOP_DM_COL,
    STOP_DM_ROW,
    STOP_FAULT,
    STOP_HORIZON,
    STOP_LOCK_KEY,
    STOP_NONDRAINABLE,
    STOP_REL_OP,
    STOP_SCHEDULED,
    _PlanVals,
    chain_effects,
    chain_entities,
    entity_admission,
    merged_ranks,
)
from repro_torch.core.engine.state import (
    OP_NONE, OP_PENDING, OP_ENROUTE, OP_QUEUED, OP_WAIT, OP_EXEC, OP_HOLD,
    SUB_SCHED, SUB_ROUND_REPLY, SUB_ROUND_AT_DM, SUB_CHILLER_WAIT, SUB_PREP_CMD,
    SUB_PREPARING, SUB_VOTE, SUB_VOTED, SUB_COMMIT_CMD, SUB_ACK, SUB_LOCAL_COMMIT,
    SUB_DONE, SUB_ABORT_PEER, SUB_ABORT_ACK, SUB_ABORTED,
    T_ABORT_WAIT, T_COMMIT_LOG,
    _SALT_MUL,
    SimConfig,
    SimState,
    _delay_salted,
    _dyn_view,
    _exec_us,
    _lanes,
    _lock_wait_deadline,
    _mw_send,
    _round_done_transition,
    _tiga_arrival,
    _tiga_fast,
    _times_flat,
)

# Max DM fan-ins per data source per window: the latency monitor applies one
# EWMA update per fan-in, composed exactly by unrolling this many masked
# applications in `_apply_window`; the (K_EWMA+1)-th same-column fan-in stops
# the window (stop reason `dm_col`).
K_EWMA = 4

# Window candidate budget: only the PLAN_CAP lex-smallest events of a lane
# can join one window (longer windows split bitwise-identically across
# steps).
PLAN_CAP = 16

I32 = torch.int32
I64 = torch.int64


def _candidates(flat: torch.Tensor, W: int):
    """The W lex-smallest (time, flat index) slots of each lane, in rank
    order, the time of the first slot after them, and every slot's rank
    saturated at W (the reference's lockstep ranks, which its W masked
    argmins give). One sort of the unique int64 keys time * M + index: the
    ranks below W are those of the order by definition."""
    B, M = flat.shape
    ids = torch.arange(M, device=flat.device)
    order = (flat.to(I64) * M + ids).sort(1).indices
    cand_i = order[:, :W]
    cand_t = flat.gather(1, cand_i)
    if M > W:
        t_w1 = flat.gather(1, order[:, W:W + 1])[:, 0]
    else:
        t_w1 = torch.full((B,), MAXI, dtype=I32, device=flat.device)
    pos = torch.full((B, M), W, dtype=I32, device=flat.device)
    pos = pos.scatter(1, cand_i, torch.arange(W, dtype=I32, device=flat.device).expand(B, W))
    return cand_i, cand_t, t_w1, pos


def _window_plan(cfg: SimConfig, bank: Bank, s: SimState) -> _PlanVals:
    """Plan every lane's maximal conflict-free *prefix* (window) of its
    event order.

    A prefix scan over the merged (candidate + chain follow-up) order finds
    the longest prefix in which every event is drainable, nothing is
    scheduled into the window's time range, and no two window events
    interact under the slot-accurate read/write-set rules of the module
    docstring. Order-aware pairwise conflicts mark the *later* event of each
    conflicting pair, so the window stops at the first conflicting event,
    whose stop reason is recorded. Per-slot tensors are exact at candidate
    slots, which are all that any window decision reads."""
    T, D, K, F = cfg.terminals, cfg.num_ds, cfg.max_ops, cfg.max_faults
    M0 = T + T * D + T * K
    # the fault / heartbeat tail slots exist only with a fault schedule
    M = M0 + (F + D if F else 0)
    BIG = M
    st, sst, inv = s.op_state, s.sub_state, s.inv
    evt_term, evt_sub, evt_op = s.term_time, s.sub_time, s.op_time
    B = st.shape[0]
    dev = st.device
    bw = torch.arange(B, device=dev)[:, None]
    w = torch.where
    flat = _times_flat(s)
    dyn2, dyn3 = _dyn_view(s.dyn, 2), _dyn_view(s.dyn, 3)
    jit3 = _lanes(s.jitter_milli, 3)

    # ---- sequential ranks of the flat time view ----------------------------
    W = min(PLAN_CAP, M)
    cand_i, cand_t, t_w1, pos = _candidates(flat, W)
    w_rank = torch.arange(W, dtype=I32, device=dev)
    ids_m = torch.arange(M, device=dev)
    hit_all = cand_i[..., None] == ids_m  # [B,W,M]
    is_sub_c = (cand_i >= T) & (cand_i < T + T * D)
    is_op_c = (cand_i >= T + T * D) & (cand_i < M0)
    sub_flat_c = (cand_i - T).clamp(0, T * D - 1)
    t_sub_c = w(is_sub_c, sub_flat_c // D, 0)
    d_sub_c = w(is_sub_c, sub_flat_c % D, 0)
    op_flat_c = (cand_i - T - T * D).clamp(0, T * K - 1)
    pos_term = pos[:, :T]
    pos_sub = pos[:, T: T + T * D].reshape(B, T, D)
    pos_op = pos[:, T + T * D: M0].reshape(B, T, K)

    # ---- per-slot event categories (what each slot would fire as) ---------
    cat_log = s.phase == T_COMMIT_LOG
    cat_sched = sst == SUB_SCHED
    cat_reply = sst == SUB_ROUND_REPLY
    cat_vote = sst == SUB_VOTE
    cat_prog = cat_reply | cat_vote
    cat_prep = sst == SUB_PREP_CMD
    cat_preparing = sst == SUB_PREPARING
    cat_commit = (sst == SUB_COMMIT_CMD) | (sst == SUB_LOCAL_COMMIT)
    cat_abort_peer = sst == SUB_ABORT_PEER
    cat_ack = sst == SUB_ACK
    cat_abort_ack = sst == SUB_ABORT_ACK
    dm_cat = cat_prog | cat_ack | cat_abort_ack
    f_cat = cat_commit | cat_abort_peer
    cat_arr = st == OP_ENROUTE
    cat_exec = st == OP_EXEC

    d_of = s.op_ds.to(I64)
    dd = torch.arange(D, device=dev)
    oh_d = d_of[..., None] == dd  # [B,T,K,D]
    opn = st != OP_NONE
    tau_row = s.tau_true[:, None, :]  # [B,1,D]
    kk = torch.arange(K, device=dev)
    # middleware<->DS link per (t, d): heal-deferred base and effective
    # (replica / degraded) RTT. Link state cannot change inside a window
    # (fault events are pinned, starts and finishes are not drainable), so
    # this is the link each handler would take at its own time
    if F:
        dd_td = dd.expand(B, T, D)
        link_td = lambda t0: _mw_send(s, s.on_repl, dd_td, t0)  # noqa: E731
    else:
        link_td = lambda t0: (t0, tau_row)  # noqa: E731

    # ---- op events: candidate-query lock decisions ------------------------
    fk = s.op_key.reshape(B, -1)
    fw = s.op_write.reshape(B, -1)
    fst = st.reshape(B, -1)
    holder = (fst == OP_EXEC) | (fst == OP_HOLD)
    waiting = fst == OP_WAIT
    # chain targets of exec completions (first QUEUED op, same DS/round)
    row_q = st == OP_QUEUED
    same_round = s.op_round == s.cur_round[..., None]
    eq_ds = s.op_ds[..., :, None] == s.op_ds[..., None, :]
    chain_mask = cat_exec[..., None] & row_q[:, :, None, :] & eq_ds & same_round[:, :, None, :]
    has_next = chain_mask.any(3)
    nxt = chain_mask.to(I32).argmax(3)  # [B,T,K]
    do_chain_cat = cat_exec & has_next
    rd_cat = cat_exec & ~has_next

    TK = T * K
    NT = CHAIN_DEPTH + 1
    ids_tk = torch.arange(TK, device=dev)
    t_op_c = op_flat_c // K
    k_op_c = op_flat_c % K
    d_op_c = d_of.reshape(B, -1).gather(1, op_flat_c)
    # queue walk: the first NT queued same-DS same-round statements of each
    # op candidate, in the argmax order the sequential chain handler takes
    qrow = (
        (row_q & same_round)[bw, t_op_c]
        & (d_of[bw, t_op_c] == d_op_c[..., None])
        & is_op_c[..., None]
    )  # [B,W,K]
    tgt_ks, tgt_exs = [], []
    for _ in range(NT):
        tgt_exs.append(qrow.any(2))
        tk_j = qrow.to(I32).argmax(2)
        tgt_ks.append(tk_j)
        qrow = qrow & (kk != tk_j[..., None])
    tgt_k = torch.stack(tgt_ks, 2)  # [B,W,NT]
    tgt_ex = torch.stack(tgt_exs, 2)
    q_self = w(is_op_c, op_flat_c, TK)  # sentinel -> padded column
    q_tgts = w(is_op_c[..., None] & tgt_ex, t_op_c[..., None] * K + tgt_k, TK)
    fk_pad = torch.cat([fk, torch.full((B, 1), -3, dtype=fk.dtype, device=dev)], 1)
    fw_pad = torch.cat([fw, torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    qs = torch.cat([q_self, q_tgts.transpose(1, 2).reshape(B, -1)], 1)  # [B,(1+NT)W]
    m_q = fk_pad.gather(1, qs)[..., None] == fk[:, None, :]  # [B,(1+NT)W,TK]
    x_held_q = (m_q & (holder & fw)[:, None]).any(2)
    s_held_q = (m_q & (holder & ~fw)[:, None]).any(2)
    wait_q = (m_q & waiting[:, None]).any(2)
    ok_q = w(fw_pad.gather(1, qs), ~x_held_q & ~s_held_q, ~x_held_q) & ~wait_q
    ok_self_c = ok_q[:, :W]
    ok_tgt = ok_q[:, W:].reshape(B, NT, W).transpose(1, 2)  # [B,W,NT]
    hit_op = q_self[..., None] == ids_tk  # [B,W,TK]
    ok = (hit_op & ok_self_c[..., None]).any(1).reshape(B, T, K)
    ok_chain = (hit_op & ok_tgt[..., :1]).any(1).reshape(B, T, K)

    exec_t = evt_op + _exec_us(cfg, s, d_of)  # [B,T,K]
    to_t = _lock_wait_deadline(dyn3, evt_op)
    arr_state = w(ok, OP_EXEC, OP_WAIT).to(I32)
    arr_time = w(ok, exec_t, to_t)
    chain_state = w(ok_chain, OP_EXEC, OP_WAIT).to(I32)
    chain_time = w(ok_chain, exec_t, to_t)

    # ---- second pass: chain entities across the scheduling fence ---------
    G = CHAIN_DEPTH
    c = chain_entities(
        s.dyn, sst, exec_t, evt_op, cand_t, cand_i, t_w1,
        is_op_c, is_sub_c, op_flat_c, sub_flat_c, t_op_c, k_op_c,
        cat_arr, do_chain_cat, ok_self_c, ok_tgt, tgt_k, tgt_ex,
        T, D, K,
    )
    r = merged_ranks(cand_t, cand_i, c, BIG)
    # per-slot iteration numbers, shifted by the follow-ups sorted before
    # each candidate
    shift_c = r.mrank_pre - w_rank
    shift_flat = w(hit_all, shift_c[..., None], 0).sum(1, dtype=I32)  # [B,M]
    it1 = s.iters[:, None] + 1
    iters_term = it1 + pos_term + shift_flat[:, :T]
    iters_sub = it1[..., None] + pos_sub + shift_flat[:, T: T + T * D].reshape(B, T, D)
    iters_op = it1[..., None] + pos_op + shift_flat[:, T + T * D: M0].reshape(B, T, K)
    iters_fu = it1[..., None] + r.mrank_fu
    iters_pfu = it1 + r.mrank_pfu

    # round completions, per (t, d) — at most one in-flight op per (t, d)
    rd3 = oh_d & rd_cat[..., None]  # [B,T,K,D]
    time_rd = w(rd3, evt_op[..., None], 0).amax(2)
    iters_rd = w(rd3, iters_op[..., None], 0).amax(2)
    rbase, rtau = link_td(time_rd)
    reply_t = rbase + _delay_salted(jit3, rtau, iters_rd * _SALT_MUL + 37)
    rmax_td = w(opn[..., None] & oh_d, s.op_round[..., None].to(I32), -1).amax(2)
    is_final_td = s.cur_round[..., None].to(I32) >= rmax_td
    centr_t = inv.sum(2, dtype=I32) == 1
    aborting_td = sst == SUB_ABORT_PEER
    prep_round_t = time_rd + dyn3.lan_rtt_us + dyn3.log_flush_us
    local_round_t = time_rd + dyn3.log_flush_us
    single_t = w(opn, s.op_round.to(I32), 0).amax(2) == 0
    fast_t = _tiga_fast(dyn2, single_t, inv, s.sub_fast)
    new_sub_state, new_sub_time = _round_done_transition(
        dyn3, is_final_td, centr_t[..., None], reply_t, prep_round_t, local_round_t,
        fast_t[..., None],
    )

    # ---- sub dispatch (DM -> DS statements) -------------------------------
    abase, atau = link_td(evt_sub)
    arrival_td = abase + _delay_salted(jit3, atau, iters_sub * _SALT_MUL + 41)
    eff_arrival_td, fast_disp_td = _tiga_arrival(
        dyn3, _lanes(s.clock_skew_us, 3), evt_sub, arrival_td
    )
    sched_at_op = cat_sched.gather(2, d_of)  # [B,T,K]
    c_ops = sched_at_op & (st == OP_PENDING) & same_round
    cand3 = c_ops[..., None] & oh_d
    has_c = cand3.any(2)  # [B,T,D]
    first_c = cand3.to(I32).argmax(2)

    # ---- DS-side prepare command / WAL-flushed vote -----------------------
    prep_time = evt_sub + dyn3.log_flush_us
    vbase, vtau = link_td(evt_sub)
    vote_t = vbase + _delay_salted(jit3, vtau, iters_sub * _SALT_MUL + 43)

    # ---- chain-entity effect values ---------------------------------------
    eff = chain_effects(
        s, F, c, t_op_c, d_op_c, t_sub_c, d_sub_c, iters_fu, iters_pfu,
        is_final_td, aborting_td, centr_t, fast_t,
    )

    # ---- DM-side fan-ins: slot-accurate read/write sets -------------------
    # slot (t, d)'s self-update is visible to fan-in (t, j) iff
    # rank(t,d) <= rank(t,j): the cumulative [T, j, d] row view
    dm_self = w(cat_reply, SUB_ROUND_AT_DM,
                w(cat_vote, SUB_VOTED, w(cat_ack, SUB_DONE, SUB_ABORTED))).to(I32)
    le3 = dm_cat[:, :, None, :] & (pos_sub[:, :, None, :] <= pos_sub[..., None])
    sta3 = w(le3, dm_self[:, :, None, :], sst[:, :, None, :].to(I32))  # [B,T,j,d]
    rd_done3 = s.rd_done[:, :, None, :] | (le3 & cat_prog[:, :, None, :])
    inv3 = inv[:, :, None, :]
    waiting_c3 = inv3 & (sta3 == SUB_CHILLER_WAIT)
    active_c3 = inv3 & ~waiting_c3
    ready_chiller_j = (
        cat_prog
        & (~active_c3 | (sta3 == SUB_VOTED)).all(3)
        & waiting_c3.any(3)
        & dyn3.chiller_two_stage
    )
    inv_rd = (oh_d & (opn & same_round)[..., None]).any(2)
    all_rd_j = (~inv_rd[:, :, None, :] | rd_done3).all(3)
    rmax_t = w(opn, s.op_round.to(I32), -1).amax(2)
    final_t = s.cur_round.to(I32) >= rmax_t
    aborting_t = s.phase == T_ABORT_WAIT
    act_j = cat_prog & all_rd_j & ~aborting_t[..., None]
    advance_j = act_j & ~final_t[..., None]  # round advance: non-drainable
    all_at_dm_j = (~inv3 | (sta3 == SUB_ROUND_AT_DM)).all(3)
    all_voted_j = (~inv3 | (sta3 == SUB_VOTED)).all(3)
    dec_c_j, dec_p_j, dec_l_j = sched.commit_decision(
        dyn3.prepare, all_at_dm_j, all_voted_j, centr_t[..., None],
        PREPARE_NONE, PREPARE_COORD, PREPARE_DECENTRAL,
    )
    gate_j = act_j & final_t[..., None]
    send_c_j = gate_j & dec_c_j
    send_p_j = gate_j & dec_p_j & ~dec_c_j
    log_t_j = gate_j & dec_l_j & ~dec_c_j & ~dec_p_j
    done_ack_j = cat_ack & (~inv3 | (sta3 == SUB_DONE)).all(3)
    done_abk_j = cat_abort_ack & (~inv3 | (sta3 == SUB_ABORTED)).all(3)
    jit4 = _lanes(s.jitter_milli, 4)
    if F:
        b3, r3 = _mw_send(s, s.on_repl[:, :, None, :], dd.expand(B, T, D, D), evt_sub[..., None])
    else:
        b3, r3 = evt_sub[..., None], tau_row[:, None]  # [B,T,D,1], [B,1,1,D]
    dd32 = dd.to(I32)
    dt_commit3 = b3 + _delay_salted(jit4, r3, iters_sub[..., None] * _SALT_MUL + 11 + dd32)
    dt_prepare3 = b3 + _delay_salted(jit4, r3, iters_sub[..., None] * _SALT_MUL + 13 + dd32)
    log_term_j = evt_sub + dyn3.log_flush_us

    # ---- terminal commit-log flush (broadcast) ----------------------------
    salt_e = iters_term[..., None] * _SALT_MUL + 31 + dd32
    lbase, ltau = link_td(evt_term[..., None])
    dt_log = lbase + _delay_salted(jit3, ltau, salt_e)

    # ---- DS-side commit apply / peer-abort release ------------------------
    ack_salt = iters_sub * _SALT_MUL + w(cat_commit, 47, 53).to(I32)
    kbase, ktau = link_td(evt_sub)
    ack_t = kbase + _delay_salted(jit3, ktau, ack_salt)
    # a release with a queued waiter on a released key is not drainable
    # (the grants would need exact ordering); probed on compact [W, K]
    # footprint rows gathered per candidate
    t_rel = w(is_sub_c, t_sub_c, 0)
    rel_c = is_sub_c & f_cat[bw, t_rel, d_sub_c]
    key_rel = s.op_key[bw, t_rel]  # [B,W,K]
    st_rel = s.op_state[bw, t_rel].to(I32)
    ds_rel_row = s.op_ds[bw, t_rel].to(I64)
    cancel_rel = rel_c[..., None] & (st_rel != OP_NONE) & (ds_rel_row == d_sub_c[..., None])
    held_rel = cancel_rel & ((st_rel == OP_EXEC) | (st_rel == OP_HOLD))
    m_rel = w(held_rel, key_rel, -3)[..., None] == fk[:, None, None, :]  # [B,W,K,TK]
    waiter_rel = (m_rel & waiting[:, None, None, :]).any(3).any(2)  # [B,W]
    sub_ids = torch.arange(T * D, device=dev)
    hit_sub_rel = w(rel_c, sub_flat_c, T * D)[..., None] == sub_ids  # [B,W,TD]
    rel_waiter_td = (hit_sub_rel & waiter_rel[..., None]).any(1).reshape(B, T, D)

    # ---- earliest-scheduled-time n(e) per slot (INF_US = nothing) and the
    # non-drainable pins ------------------------------------------------------
    n_fan = w(
        send_c_j,
        w(inv3, dt_commit3, INF_US).amin(3),
        w(send_p_j, w(inv3, dt_prepare3, INF_US).amin(3), w(log_t_j, log_term_j, INF_US)),
    )
    pinned_term = ~cat_log  # txn starts (and unexpected terminal states)
    n_term = w(cat_log, w(inv, dt_log, INF_US).amin(2), 0)
    sub_drain_cat = cat_sched | cat_prep | cat_preparing | f_cat | dm_cat
    pinned_sub = (
        ~sub_drain_cat
        | (f_cat & rel_waiter_td)
        | (dm_cat & (ready_chiller_j | advance_j | done_ack_j | done_abk_j))
    )
    n_sub = w(cat_sched, w(has_c, eff_arrival_td, INF_US), INF_US)
    n_sub = w(cat_prep, prep_time, n_sub)
    n_sub = w(cat_preparing, vote_t, n_sub)
    n_sub = w(f_cat, ack_t, n_sub)
    n_sub = w(dm_cat, n_fan, n_sub)
    n_sub = w(pinned_sub, 0, n_sub)
    rd_sched_t = w(aborting_td.gather(2, d_of), INF_US, new_sub_time.gather(2, d_of))
    pinned_op = ~(cat_arr | cat_exec)  # lock-wait timeouts / unexpected
    n_op = w(cat_arr, arr_time, w(do_chain_cat, chain_time, w(rd_cat, rd_sched_t, INF_US)))
    n_op = w(pinned_op, 0, n_op)

    # ---- order-aware pairwise conflicts: mark the LATER event of each pair
    # (a) duplicate lock keys among arrivals, chain targets and released
    #     footprints: the touch list of the candidates, each touch stamped
    #     with the merged rank of the entity making it
    pos_f_at_op = w(f_cat, pos_sub, BIG).gather(2, d_of)  # [B,T,K]
    tgt3 = do_chain_cat[..., None] & (kk == nxt[..., None])  # [B,T,K,K]
    ca_m, no = c.ca_m, torch.zeros((B, W, 1), dtype=torch.bool, device=dev)
    fu_att = c.fu_valid & c.att_has
    tv = w(ca_m, torch.cat([fu_att, no], -1), torch.cat([c.chn_c[..., None], fu_att], -1))
    tr = w(ca_m, torch.cat([r.mrank_fu, no.to(I32)], -1),
           torch.cat([r.mrank_pre[..., None], r.mrank_fu], -1))  # [B,W,NT]
    tkeys = torch.cat([fk_pad.gather(1, q_self), fk_pad.gather(1, qs[:, W:]),
                       key_rel.reshape(B, -1)], 1)
    tvalid = torch.cat([c.arr_c, tv.transpose(1, 2).reshape(B, -1), cancel_rel.reshape(B, -1)],
                       1)
    tw = torch.cat([r.mrank_pre, tr.transpose(1, 2).reshape(B, -1),
                    r.mrank_pre[..., None].expand(B, W, K).reshape(B, -1)], 1)
    eq_t = (tkeys[:, :, None] == tkeys[:, None, :]) & tvalid[:, :, None] & tvalid[:, None, :]
    dup_t = (eq_t & (tw[:, None, :] < tw[:, :, None])).any(2)
    dup_arr_c = dup_t[:, :W] & c.arr_c
    tg_dup = dup_t[:, W: W + NT * W].reshape(B, NT, W).transpose(1, 2) & tv  # [B,W,NT]
    dup_chn_c = tg_dup[..., 0] & ~c.seed_ca  # pass-1 chain attempt (CX candidate)
    fu_dup = w(ca_m, tg_dup[..., :G], tg_dup[..., 1:])  # [B,W,G] per entity
    dup_rel_c = (dup_t[:, W + NT * W:].reshape(B, W, K) & cancel_rel).any(2)
    dup_arr = (hit_op & dup_arr_c[..., None]).any(1).reshape(B, T, K)
    dup_chain = (hit_op & dup_chn_c[..., None]).any(1).reshape(B, T, K)
    conf_key_sub = (hit_sub_rel & dup_rel_c[..., None]).any(1).reshape(B, T, D)
    conf_key_op = dup_arr | dup_chain

    # (b) slot-accurate DM row rules
    trig_j = dm_cat & (
        ready_chiller_j | advance_j | send_c_j | send_p_j | log_t_j | done_ack_j | done_abk_j
    )
    pos_excl = torch.minimum(w(cat_log, pos_term, BIG), w(trig_j, pos_sub, BIG).amin(2))
    pos_nonfan = torch.minimum(
        pos_term, torch.minimum(w(~dm_cat, pos_sub, BIG).amin(2), pos_op.amin(2))
    )
    conf_row_term = pos_excl < pos_term
    conf_row_sub = (pos_excl[..., None] < pos_sub) | (dm_cat & (pos_nonfan[..., None] < pos_sub))
    conf_row_op = pos_excl[..., None] < pos_op

    # (c) at most K_EWMA fan-ins per data source per window
    col_lt = dm_cat[:, None] & (pos_sub[:, None] < pos_sub[:, :, None])  # [B,T,T',D]
    conf_col_sub = dm_cat & (col_lt.sum(2, dtype=I32) >= K_EWMA)

    # (d) a release and an earlier op event at the same (terminal, DS)
    pos_op_td = w(oh_d, pos_op[..., None], BIG).amin(2)
    conf_rel_sub = f_cat & (pos_op_td < pos_sub)
    conf_rel_op = pos_f_at_op < pos_op

    # ---- maximal prefix over the merged order -----------------------------
    zt = torch.zeros((B, T), dtype=torch.bool, device=dev)
    flatten = lambda x: x.reshape(B, -1)  # noqa: E731
    conf_key = torch.cat([zt, flatten(conf_key_sub), flatten(conf_key_op)], 1)
    conf_row = torch.cat([conf_row_term, flatten(conf_row_sub), flatten(conf_row_op)], 1)
    conf_col = torch.cat([zt, flatten(conf_col_sub), torch.zeros_like(flatten(conf_key_op))], 1)
    conf_rel = torch.cat([zt, flatten(conf_rel_sub), flatten(conf_rel_op)], 1)
    pinned_flat = torch.cat([pinned_term, flatten(pinned_sub), flatten(pinned_op)], 1)
    n_flat = torch.cat([n_term, flatten(n_sub), flatten(n_op)], 1)
    if F:
        # fault rows: pinned, schedule nothing, conflict with nothing (a due
        # one stops the window at itself). Heartbeat slots drain: a probe
        # writes only its own counter and timer, and reads reachability no
        # window event changes; its re-arm time enters the running min
        zfd = torch.zeros((B, F + D), dtype=torch.bool, device=dev)
        conf_key = torch.cat([conf_key, zfd], 1)
        conf_row = torch.cat([conf_row, zfd], 1)
        conf_col = torch.cat([conf_col, zfd], 1)
        conf_rel = torch.cat([conf_rel, zfd], 1)
        pinned_flat = torch.cat([pinned_flat, ~zfd[:, :F], zfd[:, :D]], 1)
        hb_fire = s.ds_down | (s.mw_heal > s.hb_time)
        n_hb = w(hb_fire & (s.hb_time < INF_US), s.hb_time + dyn2.hb_interval_us, INF_US)
        n_flat = torch.cat([n_flat, torch.zeros((B, F), dtype=I32, device=dev), n_hb], 1)
    else:
        hb_fire = torch.zeros((B, D), dtype=torch.bool, device=dev)
    conflict = conf_key | conf_row | conf_col | conf_rel
    horizon_i = cfg.horizon_us
    code = w(flat >= horizon_i, STOP_HORIZON,
             w(pinned_flat, STOP_NONDRAINABLE,
               w(conf_key, STOP_LOCK_KEY,
                 w(conf_row, STOP_DM_ROW,
                   w(conf_col, STOP_DM_COL, w(conf_rel, STOP_REL_OP, STOP_SCHEDULED)))))).to(I32)
    if F:
        # fault-row stoppers get their own code (the horizon stays dominant)
        fault_flat = (ids_m >= M0) & (ids_m < M0 + F)
        code = w((flat < horizon_i) & fault_flat, STOP_FAULT, code)
    adm = entity_admission(
        s.dyn, c, r, eff, conflict.gather(1, cand_i), code.gather(1, cand_i),
        n_flat.gather(1, cand_i), fu_dup, hit_all, horizon_i, T, D, K, M0, F,
    )
    return _PlanVals(
        cand_i=cand_i,
        cand_is_sub=is_sub_c,
        cand_t_sub=t_sub_c,
        cand_d_sub=d_sub_c,
        pos_term=pos_term,
        pos_sub=pos_sub,
        pos_op=pos_op,
        iters_term=iters_term,
        iters_sub=iters_sub,
        iters_op=iters_op,
        cat_log=cat_log,
        cat_sched=cat_sched,
        cat_prep=cat_prep,
        cat_preparing=cat_preparing,
        cat_commit=cat_commit,
        cat_ack=cat_ack,
        cat_prog=cat_prog,
        dm_cat=dm_cat,
        f_cat=f_cat,
        cat_arr=cat_arr,
        cat_exec=cat_exec,
        ok=ok,
        arr_state=arr_state,
        arr_time=arr_time,
        has_next=has_next,
        tgt3=tgt3,
        ok_chain=ok_chain,
        chain_state=chain_state,
        chain_time=chain_time,
        time_rd=time_rd,
        new_sub_state=new_sub_state.to(I32),
        new_sub_time=new_sub_time,
        aborting_td=aborting_td,
        arrival_td=arrival_td,
        eff_arrival_td=eff_arrival_td,
        fast_disp_td=fast_disp_td,
        has_c=has_c,
        first_c=first_c,
        prep_time=prep_time,
        vote_t=vote_t,
        dm_self=dm_self,
        ready_chiller_j=ready_chiller_j,
        advance_j=advance_j,
        send_c_j=send_c_j,
        send_p_j=send_p_j,
        log_t_j=log_t_j,
        done_ack_j=done_ack_j,
        done_abk_j=done_abk_j,
        dt_commit3=dt_commit3,
        dt_prepare3=dt_prepare3,
        log_term_j=log_term_j,
        dt_log=dt_log,
        ack_t=ack_t,
        rel_waiter_td=rel_waiter_td,
        fu_win=adm.fu_win,
        fu_term=t_op_c,
        fu_d=d_op_c,
        fu_u=c.u,
        fu_comp_k=c.comp_k,
        fu_att_has=c.att_has,
        fu_att_k=c.att_k,
        fu_att_ok=c.att_ok_t,
        fu_att_state=eff.att_state_fu,
        fu_att_time=eff.att_time_fu,
        fu_rd=eff.rd_fu,
        fu_rd_wr=eff.rd_wr_fu,
        fu_rd_state=eff.rd_state_fu,
        fu_rd_time=eff.rd_time_fu,
        pfu_win=adm.pfu_win,
        pfu_vote_t=eff.vote2,
        n_chained=adm.n_chained,
        pinned_term=pinned_term,
        pinned_sub=pinned_sub,
        pinned_op=pinned_op,
        win_term=adm.win_term,
        win_sub=adm.win_sub,
        win_op=adm.win_op,
        win_hb=adm.win_hb,
        hb_fire=hb_fire,
        n_win=adm.n_win,
        use=adm.use,
        t_last=adm.t_last,
        stop_code=adm.stop_code,
    )
