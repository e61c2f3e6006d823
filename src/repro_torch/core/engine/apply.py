"""Masked window application + the map-lane drain step (port of
`repro.core.engine.apply`).

`_apply_window` writes a planned window (`window._window_plan`) in ONE
masked pass over [B] lanes, bitwise-identical to stepping its events
sequentially; `_drainable_due` is the cheap pre-check the two drain paths
share. The lockstep lanes run both through `fused._omni_window`;
`_drain_step` is the sequential (map) lanes' drain step, host-gated
behind the pre-check, with the sequential `_step` as its fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core.netmodel import INF_US, ewma_update
from repro_torch.core.workloads import Bank
from repro_torch.core.engine.chain import _PlanVals
from repro_torch.core.engine.state import (
    N_STOP_REASONS,
    OP_NONE, OP_PENDING, OP_ENROUTE, OP_QUEUED, OP_EXEC, OP_HOLD, OP_DONE,
    SUB_SCHED, SUB_RUN, SUB_ROUND_REPLY, SUB_PREP_CMD, SUB_PREPARING, SUB_VOTE,
    SUB_COMMIT_CMD, SUB_ACK, SUB_LOCAL_COMMIT, SUB_ABORT_PEER, SUB_ABORT_ACK,
    T_COMMIT_LOG, T_COMMIT_WAIT,
    SimConfig,
    SimState,
    _times_flat,
)
from repro_torch.core.engine.step import _step
from repro_torch.core.engine.window import K_EWMA, _window_plan

I8 = torch.int8
I32 = torch.int32
I64 = torch.int64


def _apply_window(
    cfg: SimConfig,
    s_: SimState,
    v: _PlanVals,
    act_term,
    act_sub,
    act_op,
    t_now,
    iters_inc,
    drained_inc,
    windows_inc,
    stops_inc,
    *,
    fused_inc,
    xcancel,
    xlel,
    xcommit,
    xrel,
    act_hb,
    chained_inc,
    act_fu,
    act_pfu,
) -> SimState:
    """Write the events under the act_* masks ([B,T] / [B,T,D] / [B,T,K])
    and the admitted follow-ups (`act_fu` [B,W,G], `act_pfu` [B,W]) in one
    masked pass, bitwise-identical to stepping them sequentially.

    `fused._omni_window`, the one caller, selects window-OR-single-event
    masks and folds the non-drainable single event's release footprint in
    via `xcancel` / `xlel` / `xcommit` / `xrel` (all False or 0 where no
    such event), so the hotspot update runs once a step. `act_hb` [B,D]
    marks the heartbeat probes drained in the window (all False without a
    fault schedule). The per-lane increments are [B] tensors (or ints)."""
    T, D, K = cfg.terminals, cfg.num_ds, cfg.max_ops
    TK, TD = T * K, T * D
    w = torch.where
    st, sst, inv = s_.op_state, s_.sub_state, s_.inv
    evt_sub, evt_op = s_.sub_time, s_.op_time
    B = st.shape[0]
    dev = st.device
    bw = torch.arange(B, device=dev)[:, None]
    d_of = s_.op_ds.to(I64)
    dd = torch.arange(D, device=dev)
    oh_d = d_of[..., None] == dd  # [B,T,K,D]
    opn = st != OP_NONE
    same_round = s_.op_round == s_.cur_round[..., None]
    kk = torch.arange(K, device=dev)

    # ---- windowed masks ---------------------------------------------------
    due_log = act_term & v.cat_log
    due_sched = act_sub & v.cat_sched
    due_prep = act_sub & v.cat_prep
    due_preparing = act_sub & v.cat_preparing
    dm_mask = act_sub & v.dm_cat  # every one's row view is exact by plan
    due_commit = act_sub & v.cat_commit
    f_mask = act_sub & v.f_cat
    due_arr = act_op & v.cat_arr
    due_exec = act_op & v.cat_exec
    do_chain = due_exec & v.has_next
    rd = due_exec & ~v.has_next
    rd_td = (oh_d & rd[..., None]).any(2)
    sub_upd = rd_td & ~v.aborting_td
    # triggering fan-ins in the window (at most one per terminal, always the
    # last in-window event of its terminal)
    send_c_wj = dm_mask & v.send_c_j
    send_p_wj = dm_mask & v.send_p_j
    log_wj = dm_mask & v.log_t_j
    send_c_w = send_c_wj.any(2)
    send_p_w = send_p_wj.any(2)
    log_w = log_wj.any(2)
    dt_commit_w = w(send_c_wj[..., None], v.dt_commit3, 0).amax(2)
    dt_prepare_w = w(send_p_wj[..., None], v.dt_prepare3, 0).amax(2)
    log_term_w = w(log_wj, v.log_term_j, 0).amax(2)
    cancel = (opn & f_mask.gather(2, d_of)) | xcancel

    # ---- op arrays: arrivals/execs, chained statements, dispatch marks,
    # commit/abort cancellations (masks pairwise disjoint) ------------------
    op_state = w(due_arr, v.arr_state, w(due_exec, OP_HOLD, st.to(I32)))
    op_time = w(due_arr, v.arr_time, w(due_exec, INF_US, s_.op_time))
    op_enq = w(due_arr, evt_op, s_.op_enq)
    tgt3_w = v.tgt3 & do_chain[..., None]  # [B,T,K(src),K(tgt)]
    chain_tgt = tgt3_w.any(2)

    def pick(x):
        return w(tgt3_w, x[..., None], 0).amax(2)

    op_state = w(chain_tgt, pick(v.chain_state), op_state)
    op_time = w(chain_tgt, pick(v.chain_time), op_time)
    op_enq = w(chain_tgt, pick(evt_op), op_enq)
    sched_w = due_sched.gather(2, d_of)
    c_ops_w = sched_w & (st == OP_PENDING) & same_round
    is_first_w = c_ops_w & (v.first_c.gather(2, d_of) == kk) & v.has_c.gather(2, d_of)
    op_state = w(c_ops_w, w(is_first_w, OP_ENROUTE, OP_QUEUED), op_state)
    op_time = w(is_first_w, v.eff_arrival_td.gather(2, d_of), op_time)
    # chained follow-up entities: entity (r, g) completes comp_k (-> HOLD) at
    # u_g and attempts att_k (-> EXEC/WAIT). Attempts land first: an
    # entity's completion slot IS its parent's attempt target. Per-slot
    # writers are unique by the plan's dup rule + the argmax-and-clear walk.
    ids_tk = torch.arange(TK, device=dev)
    ids_td = torch.arange(TD, device=dev)
    gm = lambda x: x.transpose(1, 2).reshape(B, -1)  # noqa: E731  [B,W,G] -> [B,G*W]
    att_m = act_fu & v.fu_att_has
    att_idx = w(att_m, v.fu_term[..., None] * K + v.fu_att_k, TK)
    hit_att = gm(att_idx)[..., None] == ids_tk  # [B,G*W,TK]

    def pick_att(x):
        return w(hit_att, gm(x)[..., None], 0).amax(1).reshape(B, T, K)

    att_any = hit_att.any(1).reshape(B, T, K)
    op_state = w(att_any, pick_att(v.fu_att_state), op_state)
    op_time = w(att_any, pick_att(v.fu_att_time), op_time)
    op_enq = w(att_any, pick_att(v.fu_u), op_enq)
    comp_idx = w(act_fu, v.fu_term[..., None] * K + v.fu_comp_k, TK)
    comp_any = (gm(comp_idx)[..., None] == ids_tk).any(1).reshape(B, T, K)
    op_state = w(comp_any, OP_HOLD, op_state)
    op_time = w(comp_any, INF_US, op_time)
    op_state = w(cancel, OP_DONE, op_state).to(I8)
    op_time = w(cancel, INF_US, op_time)

    got = (due_arr & v.ok) | (do_chain & v.ok_chain)
    got_t = w(oh_d & got[..., None], evt_op[..., None], INF_US).amin(2)
    # granted follow-up attempts feed first-lock at their own u_g
    hit_ftd = (v.fu_term * D + v.fu_d)[..., None] == ids_td  # [B,W,TD]
    got_r = w(att_m & v.fu_att_ok, v.fu_u, INF_US).amin(2)
    got_t2 = w(hit_ftd, got_r[..., None], INF_US).amin(1).reshape(B, T, D)
    first_lock = torch.minimum(torch.minimum(s_.first_lock, got_t), got_t2)

    # ---- sub arrays: self-updates first, then whole-row broadcasts --------
    sub_state = w(sub_upd, v.new_sub_state, sst.to(I32))
    sub_time = w(sub_upd, v.new_sub_time, s_.sub_time)
    sub_state = w(due_prep, SUB_PREPARING, sub_state)
    sub_time = w(due_prep, v.prep_time, sub_time)
    sub_state = w(due_preparing, SUB_VOTE, sub_state)
    sub_time = w(due_preparing, v.vote_t, sub_time)
    sub_state = w(due_sched, SUB_RUN, sub_state)
    sub_time = w(due_sched, INF_US, sub_time)
    sub_arrive = w(due_sched, v.arrival_td, s_.sub_arrive)
    sub_fast = w(due_sched, v.fast_disp_td, s_.sub_fast)
    sub_state = w(dm_mask, v.dm_self, sub_state)
    sub_time = w(dm_mask, INF_US, sub_time)
    row_c = send_c_w[..., None] & inv
    sub_state = w(row_c, SUB_COMMIT_CMD, sub_state)
    sub_time = w(row_c, dt_commit_w, sub_time)
    row_p = send_p_w[..., None] & inv
    sub_state = w(row_p, SUB_PREP_CMD, sub_state)
    sub_time = w(row_p, dt_prepare_w, sub_time)
    row_e = due_log[..., None] & inv
    sub_state = w(row_e, SUB_COMMIT_CMD, sub_state)
    sub_time = w(row_e, v.dt_log, sub_time)
    sub_state = w(due_commit, SUB_ACK, sub_state)
    sub_state = w(f_mask & ~due_commit, SUB_ABORT_ACK, sub_state)
    sub_time = w(f_mask, v.ack_t, sub_time)
    sub_lel = s_.sub_lel + w(rd_td, torch.clamp_min(v.time_rd - s_.sub_arrive, 0), 0)
    # chained round completions / prepare-flush votes: their (t, d) slots
    # are disjoint from every pass-1 sub write above, except the prepare
    # flush, which overwrites its own parent's PREP_CMD -> PREPARING write
    rd_g = act_fu & v.fu_rd  # [B,W,G]; at most one g per row
    rd_w_g = rd_g & v.fu_rd_wr
    rd_any_r = rd_g.any(2)
    rd_w_r = rd_w_g.any(2)
    rd_u_r = w(rd_g, v.fu_u, 0).amax(2)
    rd_state_r = w(rd_w_g, v.fu_rd_state, 0).amax(2)
    rd_time_r = w(rd_w_g, v.fu_rd_time, 0).amax(2)

    def sc_td(val, m):
        return w(hit_ftd & m[..., None], val[..., None], 0).amax(1).reshape(B, T, D)

    rd2_w = (hit_ftd & rd_w_r[..., None]).any(1).reshape(B, T, D)
    sub_state = w(rd2_w, sc_td(rd_state_r, rd_w_r), sub_state)
    sub_time = w(rd2_w, sc_td(rd_time_r, rd_w_r), sub_time)
    rd2_any = (hit_ftd & rd_any_r[..., None]).any(1).reshape(B, T, D)
    sub_lel = sub_lel + w(
        rd2_any, torch.clamp_min(sc_td(rd_u_r, rd_any_r) - s_.sub_arrive, 0), 0
    )
    pfu_idx = w(act_pfu, v.cand_t_sub * D + v.cand_d_sub, TD)
    hit_pfu = pfu_idx[..., None] == ids_td  # [B,W,TD]
    pfu_m = hit_pfu.any(1).reshape(B, T, D)
    pfu_t = w(hit_pfu, v.pfu_vote_t[..., None], 0).amax(1).reshape(B, T, D)
    sub_state = w(pfu_m, SUB_VOTE, sub_state)
    sub_time = w(pfu_m, pfu_t, sub_time)
    rd_done = s_.rd_done | (dm_mask & v.cat_prog)

    # ---- latency monitor: one exact EWMA application per in-window fan-in
    # (the plan caps a DS column at K_EWMA fan-ins; tau_est is never read
    # inside a window) --------------------------------------------------------
    F = s_.fault_time.shape[-1]
    if F:
        # the sequential monitor's freeze (crashed-DS and replica-link
        # fan-ins feed nothing) on the effective RTT (a degrade is
        # observed); neither can change inside a window
        cnt_d = (dm_mask & ~(s_.ds_down[:, None, :] | s_.on_repl)).sum(1, dtype=I32)
        mon_sample = s_.tau_mw_eff
    else:
        cnt_d = dm_mask.sum(1, dtype=I32)  # [B,D]
        mon_sample = s_.tau_true
    tau_est = s_.tau_est
    for i in range(K_EWMA):
        tau_est = w(cnt_d > i, ewma_update(tau_est, mon_sample, cfg.beta_milli), tau_est)

    # ---- terminal phase/timer (window events own their terminals) ---------
    phase = w(send_c_w, T_COMMIT_WAIT, s_.phase.to(I32))
    phase = w(log_w, T_COMMIT_LOG, phase)
    phase = w(due_log, T_COMMIT_WAIT, phase).to(I8)
    term_time = w(send_c_w | due_log, INF_US, s_.term_time)
    term_time = w(log_w, log_term_w, term_time)

    # ---- hotspot table: one slot write per released footprint key ---------
    # Releases live at sub candidates (plus the fused pass's folded rank-0
    # release, `xrel`): the footprint lookup and Eq.(4) run on [W, K] rows.
    W = v.cand_i.shape[1]
    t_rel, d_rel = v.cand_t_sub, v.cand_d_sub
    r0, rt0, rd0 = xrel
    at0 = (torch.arange(W, device=dev) == 0) & r0[:, None]
    rel_act = (v.cand_is_sub & f_mask[bw, t_rel, d_rel]) | at0
    t_rel = w(at0, rt0[:, None], t_rel)
    d_rel = w(at0, rd0[:, None], d_rel)
    key_rel = s_.op_key[bw, t_rel]  # [B,W,K]
    st_rel = s_.op_state[bw, t_rel].to(I32)
    ds_rel = s_.op_ds[bw, t_rel].to(I64)
    cancel_rel = rel_act[..., None] & (st_rel != OP_NONE) & (ds_rel == d_rel[..., None])
    slot_c, found_c = hs_mod.lookup_slots(
        s_.hs.slot_key, w(cancel_rel, key_rel, -1).reshape(B, -1), cancel_rel.reshape(B, -1)
    )
    found_rel = found_c.reshape(B, W, K)
    lel_rel = (s_.sub_lel + xlel)[bw, t_rel, d_rel].to(torch.float32)[..., None]  # [B,W,1]
    new_w = hs_mod.eq4_masked_w(
        s_.hs.w_lat, slot_c.reshape(B, W, K), found_rel, lel_rel, cfg.alpha_milli
    )
    committed_rel = (due_commit | xcommit)[bw, t_rel, d_rel][..., None] & found_rel
    # w_lat keeps scatter-SET semantics: a duplicated key inside one
    # footprint writes one identical Eq.(4) value (and a miss writes the
    # scratch row back), so the set is order-free; the counters are integer
    # scatter-adds
    upd = found_c.to(I32)
    hs = s_.hs._replace(
        w_lat=s_.hs.w_lat.scatter(
            1, slot_c, w(found_c, new_w.reshape(B, -1), s_.hs.w_lat.gather(1, slot_c))
        ),
        a_cnt=torch.clamp_min(s_.hs.a_cnt.scatter_add(1, slot_c, -upd), 0),
        t_cnt=s_.hs.t_cnt.scatter_add(1, slot_c, upd),
        c_cnt=s_.hs.c_cnt.scatter_add(1, slot_c, committed_rel.reshape(B, -1).to(I32)),
    )

    # lock-contention-span metric (commit events, per-event warmup gate)
    lcs_have = due_commit & (s_.first_lock < INF_US) & (evt_sub >= cfg.warmup_us)
    lcs_span = w(lcs_have, (evt_sub - s_.first_lock + 500) // 1000, 0)

    # WAN-leg charging (receive-side, mirrors the sequential handlers) and
    # round completions landing directly in SUB_LOCAL_COMMIT
    lane_sum = lambda x: x.flatten(1).sum(1, dtype=I32)  # noqa: E731
    wan_inc = (
        lane_sum(due_arr)
        + lane_sum(dm_mask)
        + lane_sum(due_prep)
        + lane_sum(f_mask & (sst == SUB_COMMIT_CMD))
        + lane_sum(f_mask & (sst == SUB_ABORT_PEER) & ~s_.dyn.early_abort[:, None, None])
    )
    fast_inc = (lane_sum(sub_upd & (v.new_sub_state == SUB_LOCAL_COMMIT))
                + lane_sum(rd_w_g & (v.fu_rd_state == SUB_LOCAL_COMMIT)))

    # ---- in-window heartbeat probes: `faults._hb_event` at each slot's own
    # time (count and re-arm a firing probe, disarm one that does not fire);
    # reachability cannot change inside a window, so the plan's fire
    # predicate is exact
    extra = {}
    if F:
        hb_fired = act_hb & v.hb_fire
        extra["hb_count"] = s_.hb_count + hb_fired.to(I32)
        extra["hb_time"] = w(hb_fired, s_.hb_time + s_.dyn.hb_interval_us[:, None],
                             w(act_hb, INF_US, s_.hb_time))

    return s_._replace(
        **extra,
        now=t_now,
        iters=s_.iters + iters_inc,
        drained=s_.drained + drained_inc,
        windows=s_.windows + windows_inc,
        win_stops=s_.win_stops + stops_inc,
        fused=s_.fused + fused_inc,
        chained=s_.chained + chained_inc,
        op_state=op_state,
        op_time=op_time,
        op_enq=op_enq,
        first_lock=first_lock,
        sub_state=sub_state.to(I8),
        sub_time=sub_time,
        sub_arrive=sub_arrive,
        sub_fast=sub_fast,
        sub_lel=sub_lel,
        rd_done=rd_done,
        tau_est=tau_est,
        phase=phase,
        term_time=term_time,
        hs=hs,
        lcs_sum=s_.lcs_sum + lane_sum(lcs_span),
        lcs_cnt=s_.lcs_cnt + lane_sum(lcs_have),
        wan_legs=s_.wan_legs + wan_inc,
        fast_commits=s_.fast_commits + fast_inc,
    )


def _drainable_due(s: SimState) -> torch.Tensor:
    """[B] pre-check the reference's two drain paths share: True iff every
    event due at the lane's minimum timestamp belongs to a statically
    drainable category (so window formation, and the drain telemetry, is
    the same whichever path forms it)."""
    t_now = _times_flat(s).amin(1)
    due_term = s.term_time == t_now[:, None]
    due_sub = s.sub_time == t_now[:, None, None]
    due_op = s.op_time == t_now[:, None, None]
    sst = s.sub_state
    sub_drainable = (
        (sst == SUB_SCHED)
        | (sst == SUB_ROUND_REPLY)
        | (sst == SUB_PREP_CMD)
        | (sst == SUB_PREPARING)
        | (sst == SUB_VOTE)
        | (sst == SUB_COMMIT_CMD)
        | (sst == SUB_LOCAL_COMMIT)
        | (sst == SUB_ACK)
        | (sst == SUB_ABORT_PEER)
        | (sst == SUB_ABORT_ACK)
    )
    op_drainable = (s.op_state == OP_ENROUTE) | (s.op_state == OP_EXEC)
    clean = (
        ~(due_term & (s.phase != T_COMMIT_LOG)).any(1)
        & ~(due_sub & ~sub_drainable).flatten(1).any(1)
        & ~(due_op & ~op_drainable).flatten(1).any(1)
    )
    if s.fault_time.shape[-1]:
        # a due fault event always takes the single-event route; heartbeat
        # probes drain
        clean = clean & ~(s.fault_time == t_now[:, None]).any(1)
    return clean


def _drain_step(cfg: SimConfig, bank: Bank, s: SimState) -> SimState:
    """One drain iteration of a sequential (map) lane: apply the maximal
    conflict-free window of events in one masked pass.

    The cheap pre-check routes to the windowed pass only when every event
    due at the minimum timestamp belongs to a drainable category; txn
    starts, lock-wait timeouts, fault events and unexpected states take the
    sequential single-event `_step`, as does any window the prefix scan
    cuts below two events. Both gates are host branches on one read each.
    Bitwise-identical to `_step` (`drain=False`) but the windowed-drain
    telemetry (`drained` / `windows` / `win_stops` / `chained`); `fused`
    stays 0 on these lanes. `s` is a one-lane state, `bank` a one-lane
    bank."""
    if not bool(_drainable_due(s)):
        return _step(cfg, bank, s)
    v = _window_plan(cfg, bank, s)
    if not bool(v.use):
        return _step(cfg, bank, s)
    no = torch.zeros_like(v.use)
    stop_oh = (v.stop_code[:, None] == torch.arange(N_STOP_REASONS, device=no.device)).to(I32)
    return _apply_window(
        cfg, s, v, v.win_term, v.win_sub, v.win_op, v.t_last, v.n_win, v.n_win, 1, stop_oh,
        fused_inc=0, xcancel=False, xlel=0, xcommit=False, xrel=(no, v.cand_t_sub[:, 0],
                                                                 v.cand_d_sub[:, 0]),
        act_hb=v.win_hb, chained_inc=v.n_chained, act_fu=v.fu_win, act_pfu=v.pfu_win,
    )
