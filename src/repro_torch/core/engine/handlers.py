"""DM-side forecast + stagger (port of `repro.core.engine.handlers`
`_lel_forecast` / `_stagger`, batched over lanes). The sequential event
handlers wait for the sequential slice (ROADMAP §A).
"""

from __future__ import annotations

import torch

from repro_torch.core import hotspot as hs_mod
from repro_torch.core import scheduler as sched
from repro_torch.core.protocols import STAGGER_NET_LEL, STAGGER_NONE
from repro_torch.core.engine.state import OP_NONE, SimConfig, SimState


def _lel_forecast(cfg: SimConfig, s: SimState, bidx, t) -> torch.Tensor:
    """Eq.(5) per data source for each lane's txn t: [B, D] int32 µs."""
    row = s.op_state[bidx, t] != OP_NONE
    slot, found = hs_mod.lookup_slots(s.hs.slot_key, s.op_key[bidx, t], row)
    w = s.hs.w_lat.gather(1, slot) * found.to(torch.int32)  # [B, K]
    D = s.inv.shape[-1]
    dd = torch.arange(D, device=w.device)
    oh = (s.op_ds[bidx, t].to(torch.int64)[..., None] == dd).to(torch.int32)  # [B,K,D]
    return (w[..., None] * oh).sum(1).to(torch.int32)


def _stagger(cfg: SimConfig, s: SimState, bidx, t, inv_mask) -> torch.Tensor:
    """Dispatch offsets per DS (Eq.3 / Eq.8 / none), selected by the
    dynamic stagger knob; Eq.(8) runs in the `geo_schedule` kernel (the
    Eq.(9) half of this launch is masked off with an all-False `valid`)."""
    B, D = inv_mask.shape
    lel = (
        _lel_forecast(cfg, s, bidx, t).to(torch.float32)
        * s.lel_scale_milli.to(torch.float32)[:, None]
        / 1000.0
    ).to(torch.int32)
    lel = torch.where((s.dyn.stagger == STAGGER_NET_LEL)[:, None], lel, 0)
    zk = torch.zeros((B, 1), dtype=torch.int32, device=lel.device)
    off, _ = sched.plan_dispatch(
        s.tau_est, lel.contiguous(), inv_mask.contiguous(), zk, zk, zk, zk.to(torch.bool)
    )
    return torch.where((s.dyn.stagger == STAGGER_NONE)[:, None], 0, off)
