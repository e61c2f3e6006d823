"""Plain PyTorch version of the mLSTM kernel: a straight translation of
`repro.kernels.mlstm.ref.mlstm_ref` (xLSTM eq. 19-27, stabilized parallel
form). It materializes the [S, S] decay and score matrices. The CPU path of
the wrapper, and what `chip_smoke.py` holds the CUDA kernel against."""

from __future__ import annotations

import torch


def mlstm_ref(q, k, v, logi, logf):
    """q/k/v: [B,H,S,dh]; logi/logf: [B,H,S] -> h [B,H,S,dh] in v's dtype
    (float32 math)."""
    S, dh = q.shape[-2:]
    F = torch.cumsum(logf.float(), dim=-1)
    Dt = F[..., :, None] - F[..., None, :] + logi.float()[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dt = torch.where(causal, Dt, -torch.inf)
    m = torch.clamp(Dt.amax(dim=-1), min=-1e30)
    D = torch.exp(Dt - m[..., None])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh**-0.5)
    Sm = s * D
    norm = torch.maximum(Sm.sum(dim=-1).abs(), torch.exp(-m))
    return torch.einsum("bhqk,bhkd->bhqd", Sm / norm[..., None], v.float()).to(v.dtype)
