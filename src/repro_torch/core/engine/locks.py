"""Lock-table primitive: FIFO-fair 2PL grant set over the op arrays (port of
`repro.core.engine.locks._grant_decision`, batched over lanes).

Lock state is derived from the op arrays — record r is X-locked iff some
EXEC/HOLD op writes it, S-locked iff some EXEC/HOLD op reads it. The
sequential `_attempt_lock` / `_release_and_grant` wait for the sequential
slice; the lockstep step inlines the attempt and calls this for the grants.
"""

from __future__ import annotations

import torch

from repro_torch.core.netmodel import INF_US
from repro_torch.core.engine.state import OP_EXEC, OP_HOLD, OP_WAIT


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
