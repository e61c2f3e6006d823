"""Two-pass chain admission: follow-ups across the scheduling fence (port
of `repro.core.engine.chain`, batched over lanes).

The window plan (`window._window_plan`) would end every window at the
first event whose handler schedules work inside the window's time range
(the `scheduled` stopper). This second pass absorbs those fence stops:
each op candidate that gets (or already holds) a lock grant spawns up to
`CHAIN_DEPTH` *virtual exec completions* (its own statement, then each
next queued same-DS statement the sequential chain handler would
un-queue), and each prepare command spawns its log-flush follow-up. The
virtual entities merge with the candidates into one strict (time, flat
index, is-follow-up) order; a running-min prefix scan over that entity
space decides admission for candidates and follow-ups alike, and every
admitted follow-up is written by the apply pass with exactly the
iteration number (hash salt) and timestamp the sequential loop would
have given it.

Entity layout, per lane: ``[W candidates | CHAIN_DEPTH exec blocks of W
(generation-major) | W prepare-flush]``, ``E = W + CHAIN_DEPTH*W + W``.
Every array carries the leading [B] lane axis; index arrays are int64,
times, salts and ranks int32 (the reference's wrapping arithmetic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.netmodel import INF_US
from repro_torch.core.engine.state import (
    N_STOP_REASONS,
    OP_EXEC,
    OP_WAIT,
    SUB_PREP_CMD,
    _SALT_MUL,
    SimState,
    _delay_salted,
    _dyn_view,
    _lane_gather,
    _lanes,
    _lock_wait_deadline,
    _mw_send,
    _round_done_transition,
)

# Chain-admission depth: up to this many generations of virtual exec
# completions per op candidate join the window (a granted arrival's own
# completion is generation 1; each chained statement's completion one more).
CHAIN_DEPTH = 3

# stop-reason codes — indices into SimState.win_stops / state.STOP_REASONS
(
    STOP_HORIZON,
    STOP_NONDRAINABLE,
    STOP_SCHEDULED,
    STOP_LOCK_KEY,
    STOP_DM_ROW,
    STOP_DM_COL,
    STOP_REL_OP,
    STOP_CAP,
    STOP_FAULT,
    STOP_SCHED_CHAIN,
) = range(N_STOP_REASONS)

I32 = torch.int32
MAXI = 2**31 - 1


class _PlanVals(NamedTuple):
    """Everything the masked window pass (and the fused lockstep pass) needs,
    the reference's fields in its order: per-event ranks and salts,
    pre-state categories, the values each drainable handler would compute
    sequentially, the per-fan-in decision tensors and the prefix outcome.
    Produced by `window._window_plan`, consumed by `apply._apply_window` and
    `fused._omni_window`. Shapes below are per lane ([B] leads each)."""

    cand_i: torch.Tensor  # [W] flat event indices, rank order
    cand_is_sub: torch.Tensor  # [W] candidate is a subtxn slot
    cand_t_sub: torch.Tensor  # [W] its terminal (0 when not a sub slot)
    cand_d_sub: torch.Tensor  # [W] its DS column (0 when not a sub slot)
    pos_term: torch.Tensor  # [T] ranks of the (time, index) order, saturated at W
    pos_sub: torch.Tensor  # [T,D]
    pos_op: torch.Tensor  # [T,K]
    iters_term: torch.Tensor  # per-event iteration numbers (hash salts)
    iters_sub: torch.Tensor
    iters_op: torch.Tensor
    cat_log: torch.Tensor  # pre-state event categories
    cat_sched: torch.Tensor
    cat_prep: torch.Tensor
    cat_preparing: torch.Tensor
    cat_commit: torch.Tensor
    cat_ack: torch.Tensor
    cat_prog: torch.Tensor
    dm_cat: torch.Tensor
    f_cat: torch.Tensor
    cat_arr: torch.Tensor
    cat_exec: torch.Tensor
    ok: torch.Tensor  # [T,K] lock grant for an arrival at this slot
    arr_state: torch.Tensor
    arr_time: torch.Tensor
    has_next: torch.Tensor
    tgt3: torch.Tensor  # [T,K,K] source op chains to target op
    ok_chain: torch.Tensor
    chain_state: torch.Tensor
    chain_time: torch.Tensor
    time_rd: torch.Tensor  # [T,D] exec round completions
    new_sub_state: torch.Tensor
    new_sub_time: torch.Tensor
    aborting_td: torch.Tensor
    arrival_td: torch.Tensor  # DM dispatch + DS-side 2PC legs
    eff_arrival_td: torch.Tensor  # [T,D] first-statement fire time (TIGA deadline)
    fast_disp_td: torch.Tensor  # [T,D] TIGA in-slack flag at dispatch
    has_c: torch.Tensor
    first_c: torch.Tensor
    prep_time: torch.Tensor
    vote_t: torch.Tensor
    dm_self: torch.Tensor  # [T,D] the fan-in's own-slot state write
    ready_chiller_j: torch.Tensor  # [T,D] (j = the fan-in's sub column)
    advance_j: torch.Tensor
    send_c_j: torch.Tensor
    send_p_j: torch.Tensor
    log_t_j: torch.Tensor
    done_ack_j: torch.Tensor
    done_abk_j: torch.Tensor
    dt_commit3: torch.Tensor  # [T,D,D] (fan-in j commits to every DS d)
    dt_prepare3: torch.Tensor
    log_term_j: torch.Tensor  # [T,D]
    dt_log: torch.Tensor  # [T,D] terminal commit-log flush broadcast times
    ack_t: torch.Tensor  # DS finish (commit apply / peer-abort release)
    rel_waiter_td: torch.Tensor
    fu_win: torch.Tensor  # [W,G] admitted exec-chain follow-ups
    fu_term: torch.Tensor  # [W] seed terminal (op candidates; 0 elsewhere)
    fu_d: torch.Tensor  # [W] seed DS column
    fu_u: torch.Tensor  # [W,G] entity completion times u_g
    fu_comp_k: torch.Tensor  # [W,G] op column the entity completes (-> HOLD)
    fu_att_has: torch.Tensor  # [W,G] entity attempts a next queued statement
    fu_att_k: torch.Tensor  # [W,G] that statement's op column
    fu_att_ok: torch.Tensor  # [W,G] its lock grant
    fu_att_state: torch.Tensor  # [W,G] OP_EXEC / OP_WAIT
    fu_att_time: torch.Tensor  # [W,G] grant exec time / wait deadline
    fu_rd: torch.Tensor  # [W,G] entity completes the round (LEL accounting)
    fu_rd_wr: torch.Tensor  # [W,G] ... and the sub-slot write lands (~aborting)
    fu_rd_state: torch.Tensor  # [W,G]
    fu_rd_time: torch.Tensor  # [W,G]
    pfu_win: torch.Tensor  # [W] admitted prepare-flush follow-ups
    pfu_vote_t: torch.Tensor  # [W] their salted vote send time
    n_chained: torch.Tensor  # follow-up entities admitted this window
    pinned_term: torch.Tensor  # prefix outcome
    pinned_sub: torch.Tensor
    pinned_op: torch.Tensor
    win_term: torch.Tensor  # [T] window membership
    win_sub: torch.Tensor  # [T,D]
    win_op: torch.Tensor  # [T,K]
    win_hb: torch.Tensor  # [D] in-window heartbeat probes (zeros when F == 0)
    hb_fire: torch.Tensor  # [D] probe fires (target unreachable at its slot time)
    n_win: torch.Tensor  # events in the maximal window
    use: torch.Tensor  # window holds >= 2 events
    t_last: torch.Tensor  # timestamp of the window's last event
    stop_code: torch.Tensor  # STOP_* reason of the event that ended it


class _ChainEnts(NamedTuple):
    """Virtual follow-up entities of one window plan (pre-admission)."""

    e_c: torch.Tensor  # [W] per-statement exec cost of the seed's DS
    u_all: torch.Tensor  # [W,G+1] completion times u_1..u_{G+1}
    u: torch.Tensor  # [W,G] = u_all[..., :G]
    arr_c: torch.Tensor  # [W] candidate is a statement arrival
    chn_c: torch.Tensor  # [W] candidate is a chaining exec completion
    seed_ca: torch.Tensor  # [W] granted arrival seed
    ca_m: torch.Tensor  # [W,1] seed_ca broadcast column
    att_k: torch.Tensor  # [W,G] op column entity g attempts
    att_has: torch.Tensor  # [W,G] that attempt exists
    att_ok_t: torch.Tensor  # [W,G] its lock grant
    comp_k: torch.Tensor  # [W,G] op column entity g completes
    fu_idx: torch.Tensor  # [W,G] flat slot ids of the completions
    fu_valid: torch.Tensor  # [W,G] entity exists and is order-safe
    pre_mis: torch.Tensor  # [W] misordered first child -> conflict the seed
    fu_conf_child: torch.Tensor  # [W,G] misordered child conflicts entity g
    prep_t_c: torch.Tensor  # [W] prepare-flush follow-up time
    pfu_valid: torch.Tensor  # [W] prepare-flush entity exists


def _gen_major(x: torch.Tensor) -> torch.Tensor:
    """[B, W, G] -> [B, G*W], generation-major (the entity layout)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def chain_entities(
    dyn, sst, exec_t, evt_op, cand_t, cand_i, t_w1,
    is_op_c, is_sub_c, op_flat_c, sub_flat_c, t_op_c, k_op_c,
    cat_arr, do_chain_cat, ok_self_c, ok_tgt, tgt_k, tgt_ex,
    T: int, D: int, K: int,
) -> _ChainEnts:
    """Build the virtual follow-up entities of each op/prepare candidate.

    Entity g completes comp_k[g] at u_g = t_seed + g * exec_us and then
    attempts the next queued statement (CA seeds — granted arrivals —
    complete their own slot first; CX seeds — chaining exec completions —
    start at their queue target). All times here are salt-free, so merged
    ranks are computable before any salted value."""
    G = CHAIN_DEPTH
    B, W = cand_t.shape
    dev = cand_t.device
    e_c = (exec_t - evt_op).reshape(B, -1).gather(1, op_flat_c)  # [B,W]
    gg = torch.arange(1, G + 2, dtype=I32, device=dev)
    u_all = cand_t[..., None] + gg * e_c[..., None]  # [B,W,G+1]
    u = u_all[..., :G]
    arr_c = is_op_c & cat_arr.reshape(B, -1).gather(1, op_flat_c)
    chn_c = is_op_c & do_chain_cat.reshape(B, -1).gather(1, op_flat_c)
    seed_ca = arr_c & ok_self_c
    seed_cx = chn_c & ok_tgt[..., 0]
    ca_m = seed_ca[..., None]
    att_k = torch.where(ca_m, tgt_k[..., :G], tgt_k[..., 1:])
    att_has = torch.where(ca_m, tgt_ex[..., :G], tgt_ex[..., 1:])
    att_ok_t = torch.where(ca_m, ok_tgt[..., :G], ok_tgt[..., 1:])
    comp_k = torch.where(ca_m, torch.cat([k_op_c[..., None], tgt_k[..., : G - 1]], -1),
                         tgt_k[..., :G])
    # raw validity chain: seed admissible, every prior attempt granted, and
    # the completion time strictly inside the candidate time range
    tw1 = t_w1[:, None]
    valid_list = [(seed_ca | seed_cx) & (u[..., 0] < tw1)]
    for g in range(1, G):
        valid_list.append(
            valid_list[-1] & att_has[..., g - 1] & att_ok_t[..., g - 1] & (u[..., g] < tw1)
        )
    valid0 = torch.stack(valid_list, -1)  # [B,W,G]
    # order guard: each virtual completion must sort strictly after its
    # parent under the (time, flat index, is-follow-up) key
    fu_idx = (T + T * D) + t_op_c[..., None] * K + comp_k  # [B,W,G]
    par_t = torch.cat([cand_t[..., None], u[..., : G - 1]], -1)
    par_idx = torch.cat([cand_i[..., None], fu_idx[..., : G - 1]], -1)
    par_fu = torch.arange(G, device=dev) > 0
    ord_ok = (par_t < u) | (
        (par_t == u) & ((par_idx < fu_idx) | ((par_idx == fu_idx) & ~par_fu))
    )
    fu_ord = torch.cumprod(ord_ok.to(I32), -1).bool()
    fu_valid = valid0 & fu_ord
    ones = torch.ones((B, W, 1), dtype=torch.bool, device=dev)
    ord_pref = torch.cat([ones, fu_ord[..., :-1]], -1)
    mis = valid0 & ord_pref & ~ord_ok
    pre_mis = mis[..., 0]
    fu_conf_child = torch.cat([mis[..., 1:], ~ones], -1)
    # prepare-flush follow-up: PREP_CMD -> PREPARING fires log_flush_us
    # later on the same slot (salt-free time), then sends the salted vote
    prep_cat_c = is_sub_c & (sst == SUB_PREP_CMD).reshape(B, -1).gather(1, sub_flat_c)
    prep_t_c = cand_t + dyn.log_flush_us[:, None]
    pfu_valid = prep_cat_c & (prep_t_c < tw1)
    return _ChainEnts(
        e_c=e_c, u_all=u_all, u=u, arr_c=arr_c, chn_c=chn_c,
        seed_ca=seed_ca, ca_m=ca_m, att_k=att_k, att_has=att_has,
        att_ok_t=att_ok_t, comp_k=comp_k, fu_idx=fu_idx, fu_valid=fu_valid,
        pre_mis=pre_mis, fu_conf_child=fu_conf_child, prep_t_c=prep_t_c,
        pfu_valid=pfu_valid,
    )


class _ChainRanks(NamedTuple):
    """Merged (candidate + follow-up) rank order of one window plan."""

    ent_t: torch.Tensor  # [E] entity times (invalid keyed past every real slot)
    ent_b: torch.Tensor  # [E,E] strict order: entity a processed before b
    mrank: torch.Tensor  # [E] merged ranks (a permutation)
    mrank_pre: torch.Tensor  # [W]
    mrank_fu: torch.Tensor  # [W,G]
    mrank_pfu: torch.Tensor  # [W]


def merged_ranks(cand_t, cand_i, c: _ChainEnts, BIG: int) -> _ChainRanks:
    """Candidates + follow-ups in one (time, flat index, is-follow-up)
    order. Keys are unique (invalid follow-ups are keyed past every real
    slot), so the order is strict and mrank a permutation."""
    G = CHAIN_DEPTH
    B, W = cand_t.shape
    dev = cand_t.device
    NFU = G * W + W
    ent_valid_fu = torch.cat([_gen_major(c.fu_valid), c.pfu_valid], 1)
    ord_f = torch.arange(NFU, device=dev)
    ent_t_fu = torch.where(ent_valid_fu, torch.cat([_gen_major(c.u), c.prep_t_c], 1), MAXI)
    ent_idx_fu = torch.where(ent_valid_fu, torch.cat([_gen_major(c.fu_idx), cand_i], 1),
                             BIG + ord_f)
    ent_t = torch.cat([cand_t, ent_t_fu], 1)  # [B,E] int32
    ent_idx = torch.cat([cand_i, ent_idx_fu], 1)
    ent_fu = torch.arange(W + NFU, device=dev) >= W
    ta, tb = ent_t[:, :, None], ent_t[:, None, :]
    ia, ib = ent_idx[:, :, None], ent_idx[:, None, :]
    ent_b = (ta < tb) | ((ta == tb) & ((ia < ib) | ((ia == ib) & (~ent_fu[:, None] & ent_fu))))
    mrank = ent_b.sum(1, dtype=I32)
    return _ChainRanks(
        ent_t=ent_t,
        ent_b=ent_b,
        mrank=mrank,
        mrank_pre=mrank[:, :W],
        mrank_fu=mrank[:, W: W + G * W].reshape(B, G, W).transpose(1, 2),  # [B,W,G]
        mrank_pfu=mrank[:, W + G * W:],
    )


class _ChainEffects(NamedTuple):
    """What each admitted follow-up writes, with the salt/timestamp it
    would have had sequentially."""

    att_state_fu: torch.Tensor  # [W,G] OP_EXEC / OP_WAIT at the attempt target
    att_time_fu: torch.Tensor  # [W,G] grant exec time / wait deadline
    rd_fu: torch.Tensor  # [W,G] chain ends -> round completes at (t, d)
    abort_c2: torch.Tensor  # [W] seed's sub slot is peer-aborting
    rd_state_fu: torch.Tensor  # [W,G]
    rd_time_fu: torch.Tensor  # [W,G]
    rd_wr_fu: torch.Tensor  # [W,G] round write lands (~aborting)
    vote2: torch.Tensor  # [W] salted vote send time of the prepare flush


def chain_effects(
    s: SimState, F: int, c: _ChainEnts,
    t_op_c, d_op_c, t_sub_c, d_sub_c, iters_fu, iters_pfu,
    is_final_td, aborting_td, centr_t, fast_t,
) -> _ChainEffects:
    """With a fault schedule (F > 0) the replies and votes ride the
    effective middleware links (`_mw_send`); fault-free, (t0, tau_true[d])."""
    B = t_op_c.shape[0]
    bw = torch.arange(B, device=t_op_c.device)[:, None]
    dyn3 = _dyn_view(s.dyn, 3)
    u = c.u
    att_state_fu = torch.where(c.att_ok_t, OP_EXEC, OP_WAIT).to(I32)
    att_time_fu = torch.where(c.att_ok_t, u + c.e_c[..., None], _lock_wait_deadline(dyn3, u))
    rd_fu = c.fu_valid & ~c.att_has
    fin_c = is_final_td[bw, t_op_c, d_op_c]
    abort_c2 = aborting_td[bw, t_op_c, d_op_c]
    if F:
        rb2, rt2 = _mw_send(s, s.on_repl[bw, t_op_c, d_op_c][..., None], d_op_c[..., None], u)
    else:
        rb2, rt2 = u, _lane_gather(s.tau_true, d_op_c)[..., None]
    reply2 = rb2 + _delay_salted(_lanes(s.jitter_milli, 3), rt2, iters_fu * _SALT_MUL + 37)
    prep2 = u + dyn3.lan_rtt_us + dyn3.log_flush_us
    local2 = u + dyn3.log_flush_us
    rd_state_fu, rd_time_fu = _round_done_transition(
        dyn3, fin_c[..., None], centr_t.gather(1, t_op_c)[..., None], reply2, prep2, local2,
        fast_t.gather(1, t_op_c)[..., None],
    )
    rd_wr_fu = rd_fu & ~abort_c2[..., None]
    if F:
        vb2, vt2 = _mw_send(s, s.on_repl[bw, t_sub_c, d_sub_c], d_sub_c, c.prep_t_c)
    else:
        vb2, vt2 = c.prep_t_c, _lane_gather(s.tau_true, d_sub_c)
    vote2 = vb2 + _delay_salted(_lanes(s.jitter_milli, 2), vt2, iters_pfu * _SALT_MUL + 43)
    return _ChainEffects(
        att_state_fu=att_state_fu, att_time_fu=att_time_fu, rd_fu=rd_fu,
        abort_c2=abort_c2, rd_state_fu=rd_state_fu.to(I32), rd_time_fu=rd_time_fu,
        rd_wr_fu=rd_wr_fu, vote2=vote2,
    )


class _Admission(NamedTuple):
    """Prefix outcome of the entity-space scan."""

    n_win: torch.Tensor  # entities (== sequential events) admitted
    use: torch.Tensor  # window holds >= 2 events
    t_last: torch.Tensor  # timestamp of the window's last entity
    stop_code: torch.Tensor  # STOP_* reason
    win_term: torch.Tensor  # [T]
    win_sub: torch.Tensor  # [T,D]
    win_op: torch.Tensor  # [T,K]
    win_hb: torch.Tensor  # [D] (zeros when F == 0)
    fu_win: torch.Tensor  # [W,G] admitted exec-chain follow-ups
    pfu_win: torch.Tensor  # [W] admitted prepare-flush follow-ups
    n_chained: torch.Tensor  # follow-up entities admitted


def entity_admission(
    dyn, c: _ChainEnts, r: _ChainRanks, eff: _ChainEffects,
    conf_cand_base, code_cand, n_cand, fu_dup, hit_all, horizon_i: int,
    T: int, D: int, K: int, M0: int, F: int,
) -> _Admission:
    """The running-min rule over the [E, E] strict order: admitted
    follow-ups absorb the "scheduled" events their parents fenced on."""
    G = CHAIN_DEPTH
    B, W = conf_cand_base.shape
    dev = conf_cand_base.device
    E = W + G * W + W
    conf_cand = conf_cand_base | c.pre_mis
    # a seed whose first follow-up (or prepare flush) was admitted no longer
    # schedules anything itself: the entity carries the scheduled time
    n_pre = torch.where(c.fu_valid[..., 0] | c.pfu_valid, INF_US, n_cand)
    no = torch.zeros((B, W, 1), dtype=torch.bool, device=dev)
    child_valid = torch.cat([c.fu_valid[..., 1:], no], -1)
    n_fu = torch.where(
        c.att_has,
        torch.where(
            c.att_ok_t,
            torch.where(child_valid, INF_US, c.u_all[..., 1:]),
            _lock_wait_deadline(_dyn_view(dyn, 3), c.u),
        ),
        torch.where(eff.abort_c2[..., None], INF_US, eff.rd_time_fu),
    )
    n_fu = torch.where(c.fu_valid, n_fu, INF_US)
    n_pfu = torch.where(c.pfu_valid, eff.vote2, INF_US)
    ent_n = torch.cat([n_pre, _gen_major(n_fu), n_pfu], 1)
    w = torch.where
    fu_code = w(~c.fu_valid, STOP_CAP,
                w(c.u >= horizon_i, STOP_HORIZON, w(fu_dup, STOP_LOCK_KEY, STOP_SCHED_CHAIN)))
    pfu_code = w(~c.pfu_valid, STOP_CAP, w(c.prep_t_c >= horizon_i, STOP_HORIZON,
                                           STOP_SCHED_CHAIN))
    ent_code = torch.cat([code_cand, _gen_major(fu_code).to(I32), pfu_code.to(I32)], 1)
    ent_conf = torch.cat([conf_cand, _gen_major(fu_dup | c.fu_conf_child), no[..., 0]], 1)
    einc = r.ent_b | torch.eye(E, dtype=torch.bool, device=dev)
    cmin_e = w(einc, ent_n[:, :, None], MAXI).amin(1)
    good = (cmin_e > r.ent_t) & (r.ent_t < horizon_i) & ~ent_conf
    n_win = w(~good, r.mrank, E).amin(1).to(I32)
    before = r.mrank < n_win[:, None]
    t_last = w(before, r.ent_t, 0).amax(1)
    stop_code = w(n_win >= E, STOP_CAP,
                  w(r.mrank == n_win[:, None], ent_code, 0).sum(1, dtype=I32)).to(I32)
    win_flat = (hit_all & before[:, :W, None]).any(1)
    return _Admission(
        n_win=n_win,
        use=n_win >= 2,
        t_last=t_last,
        stop_code=stop_code,
        win_term=win_flat[:, :T],
        win_sub=win_flat[:, T: T + T * D].reshape(B, T, D),
        win_op=win_flat[:, T + T * D: M0].reshape(B, T, K),
        win_hb=win_flat[:, M0 + F:] if F else torch.zeros((B, D), dtype=torch.bool, device=dev),
        fu_win=before[:, W: W + G * W].reshape(B, G, W).transpose(1, 2),
        pfu_win=before[:, W + G * W:],
        n_chained=before[:, W:].sum(1, dtype=I32),
    )
