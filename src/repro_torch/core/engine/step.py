"""Seed-reference step mode: the single earliest event through the handler
switch (port of `repro.core.engine.step`).

`_step` takes a one-lane state ([1]-batched leaves, see `handlers`). It
picks the event on the device, reads its handler id on the host (one read
a step, the host form of the reference's `lax.switch`) and calls that one
body, so which kernels run depends on the event: this path is not captured
into a CUDA graph. It is the reference's CPU strategy (`strategy="map"`)
and the port's slow path on the card.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.workloads import Bank
from repro_torch.core.engine.faults import _h_fault, _h_hb
from repro_torch.core.engine.handlers import (
    _h_start_txn,
    _h_send_commits,
    _h_op_arrive,
    _h_op_timeout,
    _h_op_exec_done,
    _h_sub_dispatch,
    _h_dm_round_in,
    _h_ds_prep_cmd,
    _h_ds_prepared,
    _h_ds_finish,
    _h_dm_fin,
    _h_noop,
)
from repro_torch.core.engine.state import (
    OP_ENROUTE,
    OP_WAIT,
    OP_EXEC,
    SUB_SCHED,
    SUB_ROUND_REPLY,
    SUB_PREP_CMD,
    SUB_PREPARING,
    SUB_VOTE,
    SUB_COMMIT_CMD,
    SUB_ACK,
    SUB_LOCAL_COMMIT,
    SUB_ABORT_PEER,
    SUB_ABORT_ACK,
    T_IDLE,
    T_COMMIT_LOG,
    SimConfig,
    SimState,
    _times_flat,
)

# handler ids — state-twin events (reply/vote, the three lock-releasing DS
# events, the two completion acks) share one fused handler each: 12 bodies
# (14 with fault injection)
(
    H_START,
    H_SEND_COMMITS,
    H_OP_ARRIVE,
    H_OP_TIMEOUT,
    H_OP_EXEC,
    H_SUB_DISPATCH,
    H_DM_ROUND,
    H_DS_PREP_CMD,
    H_DS_PREPARED,
    H_DS_FINISH,
    H_DM_FIN,
    H_NOOP,
    H_FAULT,
    H_HB,
) = range(14)

_SUB_HANDLER = [H_NOOP] * 18
_SUB_HANDLER[SUB_SCHED] = H_SUB_DISPATCH
_SUB_HANDLER[SUB_ROUND_REPLY] = H_DM_ROUND
_SUB_HANDLER[SUB_PREP_CMD] = H_DS_PREP_CMD
_SUB_HANDLER[SUB_PREPARING] = H_DS_PREPARED
_SUB_HANDLER[SUB_VOTE] = H_DM_ROUND
_SUB_HANDLER[SUB_COMMIT_CMD] = H_DS_FINISH
_SUB_HANDLER[SUB_ACK] = H_DM_FIN
_SUB_HANDLER[SUB_LOCAL_COMMIT] = H_DS_FINISH
_SUB_HANDLER[SUB_ABORT_PEER] = H_DS_FINISH
_SUB_HANDLER[SUB_ABORT_ACK] = H_DM_FIN

_OP_HANDLER = [H_NOOP] * 8
_OP_HANDLER[OP_ENROUTE] = H_OP_ARRIVE
_OP_HANDLER[OP_WAIT] = H_OP_TIMEOUT
_OP_HANDLER[OP_EXEC] = H_OP_EXEC

_TERM_HANDLER = [H_NOOP] * 5
_TERM_HANDLER[T_IDLE] = H_START
_TERM_HANDLER[T_COMMIT_LOG] = H_SEND_COMMITS

_HANDLERS = (
    _h_start_txn,
    _h_send_commits,
    _h_op_arrive,
    _h_op_timeout,
    _h_op_exec_done,
    _h_sub_dispatch,
    _h_dm_round_in,
    _h_ds_prep_cmd,
    _h_ds_prepared,
    _h_ds_finish,
    _h_dm_fin,
    _h_noop,
    _h_fault,
    _h_hb,
)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """The three state -> handler-id tables on `device`, copied there once
    (as int64, to index with)."""
    return tuple(
        torch.tensor(tab, dtype=torch.int64, device=device)
        for tab in (_SUB_HANDLER, _OP_HANDLER, _TERM_HANDLER)
    )


def _step(cfg: SimConfig, bank: Bank, s: SimState) -> SimState:
    """Process the lane's single earliest event (one first-occurrence argmin
    over all queues).

    The seed-reference step mode, `SimConfig(drain=False, lockstep=False)`:
    every other mode stays bitwise-identical to it. The concatenated view
    orders terminal < subtxn < op < fault < hb events, and the argmin picks
    the first occurrence. The fault / heartbeat tail sections exist only
    when `cfg.max_faults > 0`. `bank` is a one-lane bank ([1]-leading
    leaves); returns the next state (out of place)."""
    T, D, K, F = cfg.terminals, cfg.num_ds, cfg.max_ops, cfg.max_faults
    M0 = T + T * D + T * K
    w = torch.where
    flat = _times_flat(s)
    i = flat.argmin(1)  # [1] int64
    t_now = flat.gather(1, i[:, None])[:, 0]
    is_term = i < T
    is_sub = ~is_term & (i < T + T * D)
    j_sub = i - T
    j_op = i - T - T * D
    t = w(is_term, i, w(is_sub, j_sub // D, j_op // K))
    idx = w(is_sub, j_sub % D, w(is_term, 0, j_op % K))
    if F:
        is_fault = (i >= M0) & (i < M0 + F)
        is_hb = i >= M0 + F
        is_tail = is_fault | is_hb
        # tail events carry their own index in `t` (fault row / DS id); the
        # row used for the state-table lookups below is clamped
        t = w(is_fault, i - M0, w(is_hb, i - M0 - F, t))
        t_look = w(is_tail, 0, t)
    else:
        t_look = t
    sub_tab, op_tab, term_tab = _tables(i.device)
    sub_h = sub_tab[s.sub_state[0, t_look, idx.clamp(max=D - 1)].to(torch.int64)]
    op_h = op_tab[s.op_state[0, t_look, idx.clamp(max=K - 1)].to(torch.int64)]
    term_h = term_tab[s.phase[0, t_look].to(torch.int64).clamp(max=4)]
    hid = w(is_term, term_h, w(is_sub, sub_h, op_h))
    if F:
        hid = w(is_fault, H_FAULT, w(is_hb, H_HB, hid))
    s = s._replace(now=t_now, iters=s.iters + 1)
    return _HANDLERS[int(hid)](cfg, bank, s, t, idx)
