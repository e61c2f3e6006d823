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


def mlstm_bwd_ref(q, k, v, logi, F, h, dh):
    """The gradient of `mlstm_ref` by explicit formulas in float32 (no
    autograd). q/k/v, the forward's output h and its gradient dh:
    [B,H,S,dh]; logi and F = cumsum(logf) (the forward's own float32 F):
    [B,H,S] -> (dq, dk, dv) in q's dtype and (dlogi, dF) float32; the
    caller turns dF into dlogf by a reverse cumsum.

    With C_ij = s q_i·k_j (s = dh^-0.5), E_ij = exp(D~_ij - m_i) (0 above
    the diagonal), W = C E, σ_i = Σ_j W_ij, n_i = max(|σ_i|, exp(-m_i)),
    a_i = [|σ_i| > exp(-m_i)] and δ_i = dh_i·h_i:
        dW_ij = (dh_i·v_j - a_i sign(σ_i) δ_i) / n_i
        dv_j  = Σ_i W_ij dh_i / n_i,    dC = dW E
        dq    = s dC k,                 dk = s dCᵀ q
        dD~   = dW W,  dlogi_j = Σ_i dD~_ij,  dF_i = Σ_j dD~_ij - dlogi_i.
    m is a constant: h does not depend on it in either branch of the
    normaliser, so its gradient is zero."""
    S, d = q.shape[-2:]
    scale = d**-0.5
    qf, kf, vf, hf, gf = (x.float() for x in (q, k, v, h, dh))
    F = F.float()
    Dt = F[..., :, None] - F[..., None, :] + logi.float()[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dt = torch.where(causal, Dt, -torch.inf)
    m = torch.clamp(Dt.amax(dim=-1), min=-1e30)
    E = torch.exp(Dt - m[..., None])
    W = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale * E
    sigma = W.sum(dim=-1)
    floor = torch.exp(-m)
    n = torch.maximum(sigma.abs(), floor)
    c = torch.where(sigma.abs() > floor, torch.sign(sigma) * (gf * hf).sum(dim=-1), 0.0)
    dW = (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - c[..., None]) / n[..., None]
    dW = torch.where(causal, dW, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", W / n[..., None], gf)
    dC = dW * E
    dq = torch.einsum("bhqk,bhkd->bhqd", dC, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dC, qf) * scale
    dDt = dW * W
    dlogi = dDt.sum(dim=-2)
    dF = dDt.sum(dim=-1) - dlogi
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogi, dF
