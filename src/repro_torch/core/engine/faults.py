"""Deterministic fault injection over B lockstep lanes (port of
`repro.core.engine.faults`): typed link / node faults and heartbeat probes.

A lane's schedule (`WorldSpec.faults`, `SimConfig.max_faults` rows of
`(t_start_us, kind, endpoint_a, endpoint_b, t_end_us, severity)`, see
`state.KIND_*`) fires as events from the fault and heartbeat tail sections
of `_times_flat`. The masked bodies below run as identity-when-off sections
at the very end of `omni._omni_step` and `fused._omni_window`, so faulted
runs stay bitwise the reference's whichever step runs them. A fault-free
config (`max_faults == 0`) reaches none of this.

The reference's scalar `f`, `d` and `active` are [B] here, and every `x[f]`
is a lane gather. Each write reads the state as it was before the call's
first write (the reference builds one `_replace` from the old state), and
the paired mesh-link writes keep the reference's order: `[a, peer]`, then
`[peer, a]`.

Failure detection is `DynProto.detect_delay_us`: `init_state` shifts every
crash / partition start by it, so the event here IS the detection point.
Heartbeat probes gate on reachability (crashed OR partitioned from the
middleware), not on liveness.
"""

from __future__ import annotations

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core.netmodel import INF_US
from repro_torch.core.engine.state import (
    CAUSE_CRASH, KIND_CRASH, KIND_PARTITION, KIND_DEGRADE,
    OP_NONE, OP_DONE, OP_ENROUTE,
    SUB_ROUND_REPLY, SUB_PREP_CMD, SUB_PREPARING, SUB_VOTE, SUB_COMMIT_CMD, SUB_ACK,
    SUB_LOCAL_COMMIT, SUB_DONE, SUB_ABORT_PEER, SUB_ABORT_ACK, SUB_ABORTED,
    T_ACTIVE, T_COMMIT_LOG, T_ABORT_WAIT,
    SimConfig, SimState, _delay_salted, _ds_send, _mw_send, _salt,
)

I8 = torch.int8
I32 = torch.int32
I64 = torch.int64


def _fault_event(cfg: SimConfig, s: SimState, f: torch.Tensor, active: torch.Tensor) -> SimState:
    """Fault-schedule row f[b] of each lane fires where active[b] (identity
    elsewhere). Stage 0 is the row's start, stage 1 its end:

    CRASH: the DS goes down, the latency monitor's input freezes, every
    engaged transaction with undecided work there crash-aborts (its peers
    through SUB_ABORT_PEER), the victims' ops at the dead DS are wiped,
    decided commands addressed to it wait for recovery, the probe is armed.

    PARTITION of the middleware<->b link: `mw_heal[b]` stamped, the
    unreachability charge started, the probe armed; messages in flight on
    the link are held to the heal time (replica-served subtxns exempt).
    PARTITION of a mesh link only stamps `ds_heal` both ways.

    DEGRADE: the link's effective RTT scaled by severity/1000 at the start,
    restored at the end."""
    T, D = cfg.terminals, cfg.num_ds
    w = torch.where
    B = s.now.shape[0]
    dev = s.now.device
    bidx = torch.arange(B, device=dev)
    f = f.to(I64)
    now = s.now
    kind = s.fault_kind[bidx, f]
    peer = s.fault_peer[bidx, f].to(I64)
    sev = s.fault_sev[bidx, f]
    endp_a = s.fault_ds[bidx, f]
    is_mw = endp_a < 0  # middleware side of a link fault
    # DS-side endpoint: the crashed DS, the mw link's far end, or mesh a
    node = w(is_mw, peer, endp_a.to(I64))
    a_ix = endp_a.clamp(min=0).to(I64)  # safe mesh row index (masked when is_mw)

    stage = s.fault_stage[bidx, f]
    start = active & (stage == 0)
    end = active & (stage == 1)
    rec_t = s.fault_recover[bidx, f]

    crash = start & (kind == KIND_CRASH)
    crash_rec = end & (kind == KIND_CRASH)
    part_mw = (kind == KIND_PARTITION) & is_mw
    part_ds = (kind == KIND_PARTITION) & ~is_mw
    degr_mw = (kind == KIND_DEGRADE) & is_mw
    degr_ds = (kind == KIND_DEGRADE) & ~is_mw
    # unreachability spell (crash or mw partition): availability + heartbeat
    cut_start = start & ((kind == KIND_CRASH) | part_mw)
    cut_end = end & ((kind == KIND_CRASH) | part_mw)

    def put(x, j, v):  # x[b, j[b]] = v[b]
        return x.index_put((bidx, j), v.to(x.dtype))

    # schedule row + reachability bookkeeping, every value from the old state
    # (a detection delay can push the start past t_end: the end is floored
    # to strictly after now)
    ft = s.fault_time[bidx, f]
    since = s.down_since[bidx, node]
    hb = s.hb_time[bidx, node]
    s = s._replace(
        fault_stage=put(s.fault_stage, f, w(start, 1, w(end, 2, stage.to(I32)))),
        fault_time=put(s.fault_time, f,
                       w(start, torch.maximum(rec_t, now + 1), w(end, INF_US, ft))),
        ds_down=put(s.ds_down, node, w(crash, True, w(crash_rec, False, s.ds_down[bidx, node]))),
        mw_heal=put(s.mw_heal, node, w(start & part_mw, rec_t, s.mw_heal[bidx, node])),
        down_since=put(s.down_since, node, w(cut_start, now, since)),
        down_us=put(s.down_us, node, s.down_us[bidx, node] + w(cut_end, now - since, 0)),
        hb_time=put(s.hb_time, node,
                    w(cut_start, now + s.dyn.hb_interval_us, w(cut_end, INF_US, hb))),
    )

    # ---- mesh partition / degrade: pure link-state writes -------------------
    heal_ab = w(start & part_ds, rec_t, s.ds_heal[bidx, a_ix, peer])
    heal_ba = w(start & part_ds, rec_t, s.ds_heal[bidx, peer, a_ix])
    tt = s.tau_true[bidx, node]
    eff_mw = w(start & degr_mw, tt * sev // 1000,
               w(end & degr_mw, tt, s.tau_mw_eff[bidx, node]))
    tds_ab, tds_ba = s.tau_ds[bidx, a_ix, peer], s.tau_ds[bidx, peer, a_ix]
    eff_ab = w(start & degr_ds, tds_ab * sev // 1000,
               w(end & degr_ds, tds_ab, s.tau_ds_eff[bidx, a_ix, peer]))
    eff_ba = w(start & degr_ds, tds_ba * sev // 1000,
               w(end & degr_ds, tds_ba, s.tau_ds_eff[bidx, peer, a_ix]))
    s = s._replace(
        ds_heal=s.ds_heal.index_put((bidx, a_ix, peer), heal_ab)
        .index_put((bidx, peer, a_ix), heal_ba),
        tau_mw_eff=put(s.tau_mw_eff, node, eff_mw),
        tau_ds_eff=s.tau_ds_eff.index_put((bidx, a_ix, peer), eff_ab)
        .index_put((bidx, peer, a_ix), eff_ba),
    )

    # ---- crash cascade ------------------------------------------------------
    # victims: engaged transactions whose subtxn at the dead DS has not
    # reached the commit decision and is not already aborting
    std = s.sub_state[bidx, :, node]  # [B,T]
    post = (
        (std == SUB_COMMIT_CMD) | (std == SUB_ACK) | (std == SUB_LOCAL_COMMIT) | (std == SUB_DONE)
    )
    abortf_d = (std == SUB_ABORT_PEER) | (std == SUB_ABORT_ACK) | (std == SUB_ABORTED)
    engaged = (s.phase == T_ACTIVE) | (s.phase == T_COMMIT_LOG)
    victim = crash[:, None] & s.inv[bidx, :, node] & engaged & ~post & ~abortf_d  # [B,T]

    # wipe the victims' ops at the dead DS (state is op-derived: this IS the
    # lock release there)
    node3 = node[:, None, None]
    op_at_d = (s.op_state != OP_NONE) & (s.op_ds.to(I64) == node3)
    wipe = victim[..., None] & op_at_d
    s = s._replace(
        op_state=w(wipe, OP_DONE, s.op_state.to(I32)).to(I8),
        op_time=w(wipe, INF_US, s.op_time),
    )

    # hot-table bookkeeping for the wiped footprint: a_cnt -> t_cnt without
    # the Eq.(4) w_lat update (a crash-truncated span is no latency sample).
    # Integer scatter-adds: repeated slots add in any order
    slot, found = hs_mod.lookup_slots(s.hs.slot_key, s.op_key.reshape(B, -1), wipe.reshape(B, -1))
    upd = found.to(I32)
    s = s._replace(hs=s.hs._replace(
        a_cnt=torch.clamp_min(s.hs.a_cnt.scatter_add(1, slot, -upd), 0),
        t_cnt=s.hs.t_cnt.scatter_add(1, slot, upd),
    ))

    # peer-abort fan-out over the victims (direct DS<->DS notify under
    # early_abort, else routed through the DM; the co-located geo-agent acks
    # the dead DS's own slot), on the effective links
    ids = torch.arange(D, device=dev)
    ids32 = ids.to(I32)
    tids = torch.arange(T, device=dev, dtype=I32)
    jit = s.jitter_milli
    sa = _salt(s, 59)[:, None, None] + tids[:, None] * D + ids32  # [B,T,D]
    mesh_base, mesh_tau = _ds_send(s, node, ids.expand(B, D), now[:, None])  # [B,D]
    notify_direct = mesh_base[:, None] + _delay_salted(jit[:, None, None], mesh_tau[:, None], sa)
    tau_node = s.tau_mw_eff[bidx, node][:, None]
    to_dm = now[:, None] + _delay_salted(jit[:, None], tau_node, _salt(s, 61)[:, None] + tids)
    dm_base, dm_tau = _mw_send(s, s.on_repl, ids.expand(B, T, D), to_dm[..., None])
    notify_dm = dm_base + _delay_salted(jit[:, None, None], dm_tau, sa)
    notify = w(s.dyn.early_abort[:, None, None], notify_direct, notify_dm)  # [B,T,D]
    own_ack = now[:, None] + _delay_salted(jit[:, None], tau_node, _salt(s, 67)[:, None] + tids)

    at_d = (ids == node[:, None])[:, None]  # [B,1,D]
    abortf = (
        (s.sub_state == SUB_ABORT_PEER) | (s.sub_state == SUB_ABORT_ACK)
        | (s.sub_state == SUB_ABORTED)
    )
    peers = victim[..., None] & s.inv & ~at_d & ~abortf
    own = victim[..., None] & at_d
    new_sub = w(peers, SUB_ABORT_PEER, w(own, SUB_ABORT_ACK, s.sub_state.to(I32)))
    new_tm = w(peers, notify, w(own, own_ack[..., None], s.sub_time))

    # DS-side commands addressed to the dead DS wait for its recovery
    rec3 = rec_t[:, None, None]
    ds_side = (
        (std == SUB_COMMIT_CMD) | (std == SUB_LOCAL_COMMIT) | (std == SUB_PREP_CMD)
        | (std == SUB_PREPARING) | (std == SUB_ABORT_PEER)
    )
    defer = crash[:, None] & ds_side & ~victim  # [B,T]
    new_tm = w(defer[..., None] & at_d, torch.maximum(new_tm, rec3), new_tm)

    # ---- mw-partition in-flight deferral: messages crossing the severed
    # link are held to the heal time (replica-served subtxns exempt) --------
    in_flight = (
        (std == SUB_ROUND_REPLY) | (std == SUB_PREP_CMD) | (std == SUB_VOTE)
        | (std == SUB_COMMIT_CMD) | (std == SUB_ACK) | (std == SUB_ABORT_PEER)
        | (std == SUB_ABORT_ACK)
    )
    cut = start & part_mw
    repl_node = s.on_repl[bidx, :, node]  # [B,T]
    pdefer = cut[:, None] & in_flight & ~repl_node
    new_tm = w(pdefer[..., None] & at_d, torch.maximum(new_tm, rec3), new_tm)
    op_enroute = (s.op_state == OP_ENROUTE) & (s.op_ds.to(I64) == node3)
    opdef = cut[:, None, None] & op_enroute & ~repl_node[..., None]  # [B,T,K]
    s = s._replace(op_time=w(opdef, torch.maximum(s.op_time, rec3), s.op_time))

    return s._replace(
        sub_state=new_sub.to(I8),
        sub_time=new_tm,
        phase=w(victim, T_ABORT_WAIT, s.phase.to(I32)).to(I8),
        term_time=w(victim, INF_US, s.term_time),
        abort_cause=w(victim, CAUSE_CRASH, s.abort_cause),
    )


def _hb_event(cfg: SimConfig, s: SimState, d: torch.Tensor, active: torch.Tensor) -> SimState:
    """Heartbeat probe at DS d[b] of each lane where active[b]: counted and
    re-armed while the DS is unreachable (crashed or partitioned from the
    middleware), disarmed otherwise (the can't-spin safety valve)."""
    w = torch.where
    bidx = torch.arange(s.now.shape[0], device=s.now.device)
    d = d.to(I64)
    fire = active & (s.ds_down[bidx, d] | (s.mw_heal[bidx, d] > s.now))
    hb = s.hb_time[bidx, d]
    return s._replace(
        hb_count=s.hb_count.index_put((bidx, d), s.hb_count[bidx, d] + fire.to(I32)),
        hb_time=s.hb_time.index_put(
            (bidx, d), w(fire, s.now + s.dyn.hb_interval_us, w(active, INF_US, hb))
        ),
    )


def _tail_event(i: torch.Tensor, M0: int, F: int, D: int):
    """Each lane's picked flat index i [B] read against the fault and
    heartbeat tail sections: (is_fault, is_hb, fault row, heartbeat DS), the
    row and DS clamped into range where the event is not theirs."""
    is_fault = (i >= M0) & (i < M0 + F)
    is_hb = i >= M0 + F
    f = torch.where(is_fault, i - M0, 0).clamp(max=F - 1)
    d = torch.where(is_hb, i - M0 - F, 0).clamp(max=D - 1)
    return is_fault, is_hb, f, d


def _failover_admission(s: SimState, inv_new, oh_b, valid_b, write_b, now):
    """A txn start against unreachable data sources ([B] lanes; the
    footprint's DS one-hot oh_b [B,K,D]): it fails fast (`hit_down` [B])
    when it touches an unreachable DS, unless every hit DS has a replica
    and a read-only footprint there; then its subtxns there fail over to
    the replicas (`fo` [B,D])."""
    hit_v = inv_new & (s.ds_down | (s.mw_heal > now[:, None]))
    writes_at_d = (oh_b & (valid_b & write_b)[..., None]).any(1)
    can_fo = hit_v & (s.repl_tau < INF_US) & ~writes_at_d
    do_failover = hit_v.any(1) & (~hit_v | can_fo).all(1)
    return hit_v.any(1) & ~do_failover, hit_v & do_failover[:, None]


def _failover_routing(s: SimState, t, now, fo, dispatching, gate_fin, valid_b, write_b, ds_b):
    """One on_repl row write: a dispatching start routes its `fo` subtxns
    to the replicas (failovers, stale reads and the staleness window
    counted), a finished txn releases the routing."""
    w = torch.where
    bidx = torch.arange(t.shape[0], device=t.device)
    D = fo.shape[1]
    stale_w = w(fo, now[:, None] - s.down_since + s.repl_lag_us[:, None], 0)
    fo_op = fo.gather(1, ds_b.to(I64).clamp(0, D - 1))  # fo[ds_b]
    row = s.on_repl[bidx, t]
    return s._replace(
        on_repl=s.on_repl.index_put(
            (bidx, t), w(dispatching[:, None], fo, w(gate_fin[:, None], False, row))),
        failovers=s.failovers + w(dispatching, fo.sum(1, dtype=I32), 0),
        stale_reads=s.stale_reads
        + w(dispatching, (valid_b & ~write_b & fo_op).sum(1, dtype=I32), 0),
        max_stale_us=torch.maximum(s.max_stale_us, w(dispatching, stale_w.amax(1), 0)),
    )


def _h_fault(cfg: SimConfig, bank, s: SimState, f, idx) -> SimState:
    """The sequential step's fault branch: row f fires in every lane."""
    return _fault_event(cfg, s, f, torch.ones_like(f, dtype=torch.bool))


def _h_hb(cfg: SimConfig, bank, s: SimState, d, idx) -> SimState:
    """The sequential step's heartbeat branch: the probe at d fires."""
    return _hb_event(cfg, s, d, torch.ones_like(d, dtype=torch.bool))
