"""Latency-aware scheduling math (port of `repro.core.scheduler`).

  Eq.(3)  t_start(T_ij) = max_s tau_is - tau_ij                     (low contention)
  Eq.(8)  t_start(T_ij) = max_s (tau_is + LEL_is) - (tau_ij + LEL_ij)
  Eq.(9)  Pr_abort(T_i) = 1 - prod_r (c_cnt_r / t_cnt_r) ** max(a_cnt_r - 1, 0)

The elementwise functions here are the plain PyTorch forms. `plan_dispatch`,
the batched Eq.(8) + Eq.(9) entry the lockstep engine calls, goes through the
`geo_schedule` kernel on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.hotspot import sum_last
from repro_torch.core.netmodel import INF_US


def stagger_offsets(tau, involved, lel=None, scale_milli: int = 1000) -> torch.Tensor:
    """Per-participant dispatch offsets [..., D] int32, Eq.(3) / Eq.(8);
    0 for the slowest participant and for entries not involved.

    int32 throughout, as the reference: `lel * scale_milli` wraps for
    products >= 2**31, so callers pre-scale the forecast (identity scale
    skips the multiply)."""
    tau = tau.to(torch.int32)
    if lel is None:
        cost = tau
    else:
        scaled = lel.to(torch.int32)
        if scale_milli != 1000:
            scaled = scaled * scale_milli // 1000
        cost = tau + scaled
    masked = torch.where(involved, cost, -1)
    cmax = masked.amax(dim=-1, keepdim=True)
    off = torch.where(involved, cmax - cost, 0)
    return torch.clamp_min(off, 0).to(torch.int32)


def lock_contention_span(tau, involved, offsets) -> torch.Tensor:
    """Analytic LCS per participant under the no-data-conflict model of §IV-B."""
    total = torch.where(involved, offsets + tau, -1)
    tmax = total.amax(dim=-1, keepdim=True)
    return torch.where(involved, tmax - offsets, 0).to(torch.int32)


def success_log_prob(c_cnt, t_cnt, a_cnt) -> torch.Tensor:
    """max(a-1, 0) * log clip((c+1)/(t+1), 1e-6, 1), float32 op by op."""
    t = torch.clamp_min(t_cnt.to(torch.float32), 0.0) + 1.0
    c = torch.minimum(torch.clamp_min(c_cnt.to(torch.float32) + 1.0, 0.0), t)
    ratio = torch.clamp(c / t, 1e-6, 1.0)
    expo = torch.clamp_min(a_cnt.to(torch.float32) - 1.0, 0.0)
    return expo * torch.log(ratio)


def abort_probability(c_cnt, t_cnt, a_cnt, valid) -> torch.Tensor:
    """Pr_abort of Eq.(9): [..., K] stats -> [...] float32. The log-sum runs
    in index order k = 0..K-1 (`sum_last`), the order the kernel uses."""
    lp = torch.where(valid, success_log_prob(c_cnt, t_cnt, a_cnt), 0.0)
    return 1.0 - torch.exp(sum_last(lp))


def admission_decision(p_abort, u01, blocked_cnt, max_blocked):
    """Late transaction scheduling (§IV-C): block with probability p_abort;
    a txn blocked `max_blocked` times is aborted instead. -> (block, abort)."""
    want_block = u01 < p_abort
    abort = want_block & (blocked_cnt >= max_blocked)
    return want_block & ~abort, abort


def plan_dispatch(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid):
    """Batched Eq.(8) offsets [N, D] int32 + Eq.(9) p_abort [N] float32
    through the `geo_schedule` kernel (its plain version on CPU tensors)."""
    from repro_torch.kernels.geo_schedule.ops import geo_schedule

    return geo_schedule(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid)


def commit_decision(prepare, all_at_dm, all_voted, centralized, prepare_none, prepare_coord, prepare_decentral):
    """The DM's commit-phase decision, elementwise: (do_commit, do_prepare,
    do_log); the caller applies commit > prepare > log priority."""
    do_commit = torch.where(prepare == prepare_none, all_at_dm, centralized & all_at_dm)
    do_prepare = (prepare == prepare_coord) & all_at_dm & ~centralized
    do_log = (
        ((prepare == prepare_coord) | (prepare == prepare_decentral)) & all_voted & ~centralized
    )
    return do_commit, do_prepare, do_log


def round_barrier_next_dispatch(now, tau, involved_next, lel) -> torch.Tensor:
    """Dispatch times for the next interactive round."""
    off = stagger_offsets(tau, involved_next, lel)
    return torch.where(involved_next, now + off, INF_US)
