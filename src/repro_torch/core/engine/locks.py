"""Lock-table primitives: FIFO-fair 2PL over the op arrays (port of
`repro.core.engine.locks`).

Lock state is derived from the op arrays — record r is X-locked iff some
EXEC/HOLD op writes it, S-locked iff some EXEC/HOLD op reads it — so there
is no separate lock table to keep consistent. `_grant_decision` is batched
over lanes and serves every step mode: the lockstep steps inline the
attempt and call it for the grants. `_attempt_lock` / `_release_and_grant`
are the sequential handlers' primitives: they take a one-lane ([1]-batched)
state and the event's coordinates as [1] index tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.netmodel import INF_US
from repro_torch.core.engine.state import (
    OP_DONE, OP_EXEC, OP_HOLD, OP_NONE, OP_WAIT, SimConfig, SimState, _exec_us,
    _lock_wait_deadline, _put,
)

I8 = torch.int8
I64 = torch.int64


def _attempt_lock(cfg: SimConfig, s: SimState, t, k) -> SimState:
    """Op (t, k) of the lane is at its data source and requests its lock
    (FIFO-fair: a new request queues behind any existing waiter, as in the
    MySQL/PG record-lock wait queues the paper's data sources use)."""
    r = s.op_key[0, t, k]
    wr = s.op_write[0, t, k]
    d = s.op_ds[0, t, k].to(I64)
    st = s.op_state
    on_r = s.op_key == r
    holder = (st == OP_EXEC) | (st == OP_HOLD)
    x_held = (holder & on_r & s.op_write).any()
    s_held = (holder & on_r & ~s.op_write).any()
    waiter = ((st == OP_WAIT) & on_r).any()
    ok = torch.where(wr, ~x_held & ~s_held, ~x_held) & ~waiter
    w = torch.where
    return s._replace(
        op_state=_put(s.op_state, (t, k), w(ok, OP_EXEC, OP_WAIT)),
        op_time=_put(s.op_time, (t, k), w(ok, s.now + _exec_us(cfg, s, d),
                                          _lock_wait_deadline(s.dyn, s.now))),
        op_enq=_put(s.op_enq, (t, k), s.now),
        # first_lock.at[t, d].min(...): one element, an explicit min
        first_lock=_put(s.first_lock, (t, d),
                        torch.minimum(s.first_lock[0, t, d], w(ok, s.now, INF_US))),
    )


def _grant_decision(held, rel_keys, flat_state, flat_key, flat_write, flat_enq):
    """FIFO-compatible grant set for a release's keys.

    held/rel_keys: [B, K] the releasing row's held mask + keys (non-held =
    -2); flat_*: the [B, T*K] post-cancel op views. Grants all shared waiters
    enqueued before the earliest exclusive waiter (unless an exclusive holder
    remains), else the earliest exclusive waiter (first occurrence on ties,
    if no holder of either mode remains). Returns [B, T*K] bool."""
    holderf = ((flat_state == OP_EXEC) | (flat_state == OP_HOLD))[:, None, :]
    waitf = (flat_state == OP_WAIT)[:, None, :]
    wr = flat_write[:, None, :]
    enq = flat_enq[:, None, :]
    eq = flat_key[:, None, :] == rel_keys[:, :, None]  # [B, K, T*K]
    rem_x = (eq & holderf & wr).any(-1)
    rem_s = (eq & holderf & ~wr).any(-1)
    M = held[:, :, None] & eq & waitf
    exq = torch.where(M & wr, enq, INF_US)
    ex_min = exq.amin(-1)  # [B, K]
    enq_m = torch.where(M, enq, INF_US)
    grant_s = M & ~wr & (enq_m < ex_min[..., None]) & ~rem_x[..., None]
    any_s = grant_s.any(-1)
    x_row = exq.argmin(-1)
    grant_x_ok = (ex_min < INF_US) & ~any_s & ~rem_x & ~rem_s
    cols = torch.arange(M.shape[-1], device=M.device)
    grant_x = (cols == x_row[..., None]) & grant_x_ok[..., None] & M & wr
    return (grant_s | grant_x).any(1)


def _release_and_grant(cfg: SimConfig, s: SimState, t, d) -> SimState:
    """Release every lock txn t of the lane holds at data source d, cancel
    its remaining ops there, and grant waiting requests FIFO-compatibly."""
    T, K, D = cfg.terminals, cfg.max_ops, cfg.num_ds
    w = torch.where
    row_state = s.op_state[0, t]  # [1, K]
    mine = (row_state != OP_NONE) & (s.op_ds[0, t].to(I64) == d[:, None])
    held = mine & ((row_state == OP_EXEC) | (row_state == OP_HOLD))
    rel_keys = w(held, s.op_key[0, t], -2)  # -2 matches nothing
    # cancel all my ops at d (this *is* the release: lock state is op-derived)
    s = s._replace(
        op_state=_put(s.op_state, (t,), w(mine, OP_DONE, row_state)),
        op_time=_put(s.op_time, (t,), w(mine, INF_US, s.op_time[0, t])),
    )
    # ---- grant waiters on the released keys (post-release views) ----------
    flat_state = s.op_state.reshape(1, -1)
    flat_ds = s.op_ds.reshape(1, -1).to(I64)
    granted = _grant_decision(
        held, rel_keys, flat_state, s.op_key.reshape(1, -1), s.op_write.reshape(1, -1),
        s.op_enq.reshape(1, -1),
    )
    exec_t = s.now[:, None] + _exec_us(cfg, s, flat_ds)
    # first-lock bookkeeping for grantees: a scatter-min whose non-grantees
    # write INF_US into the pad slot T*D
    gt = torch.arange(T * K, device=flat_ds.device) // K
    idx = w(granted, gt * D + flat_ds, T * D)
    fl_pad = torch.cat([s.first_lock.reshape(1, -1), torch.full_like(s.now[:, None], INF_US)], 1)
    fl_pad = fl_pad.scatter_reduce(1, idx, w(granted, s.now[:, None], INF_US), "amin")
    return s._replace(
        op_state=w(granted, OP_EXEC, flat_state).to(I8).reshape(1, T, K),
        op_time=w(granted, exec_t, s.op_time.reshape(1, -1)).reshape(1, T, K),
        first_lock=fl_pad[:, : T * D].reshape(1, T, D),
    )
