"""Plain PyTorch version of the mLSTM kernel: a straight translation of
`repro.kernels.mlstm.ref.mlstm_ref` (xLSTM eq. 19-27, stabilized parallel
form). It materializes the [S, S] decay and score matrices. The CPU path of
the wrapper, and what `chip_smoke.py` holds the CUDA kernel against."""

from __future__ import annotations

import torch


def mlstm_ref(q, k, v, logi, logf, with_stats=False):
    """q/k/v: [B,H,S,dh]; logi/logf: [B,H,S] -> h [B,H,S,dh] in v's dtype
    (float32 math). `with_stats`: (h, m, n), the rows' statistics float32
    [B,H,S] that the forward kernel writes for the backward: m_i = max_j D~,
    and the normaliser max(|σ_i|, exp(-m_i), 1e-30) of σ_i = Σ_j W_ij,
    carrying σ_i's sign where |σ_i| sets it (`mlstm_bwd_ref` reads a_i and
    sign(σ_i) from it)."""
    S, dh = q.shape[-2:]
    F = torch.cumsum(logf.float(), dim=-1)
    Dt = F[..., :, None] - F[..., None, :] + logi.float()[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dt = torch.where(causal, Dt, -torch.inf)
    m = torch.clamp(Dt.amax(dim=-1), min=-1e30)
    D = torch.exp(Dt - m[..., None])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh**-0.5)
    Sm = s * D
    sigma = Sm.sum(dim=-1)
    norm = torch.maximum(sigma.abs(), torch.exp(-m))
    h = torch.einsum("bhqk,bhkd->bhqd", Sm / norm[..., None], v.float()).to(v.dtype)
    if with_stats:
        floor = _floor(m)
        return h, m, torch.where(sigma.abs() > floor, sigma, floor)
    return h


def _floor(m):
    """The normaliser's floor max(exp(-m), 1e-30), as the kernels take it."""
    return torch.clamp(torch.exp(-m), min=1e-30)


def mlstm_bwd_ref(q, k, v, logi, F, h, dh, m, n):
    """The gradient of `mlstm_ref` by explicit formulas in float32 (no
    autograd). q/k/v, the forward's output h and its gradient dh:
    [B,H,S,dh]; logi and F = cumsum(logf) (the forward's own float32 F),
    and the forward's row statistics m and signed n
    (`mlstm_ref(..., with_stats=True)`): [B,H,S] -> (dq, dk, dv) in q's
    dtype and (dlogi, dF) float32; the caller turns dF into dlogf by a
    reverse cumsum.

    With C_ij = s q_i·k_j (s = dh^-0.5), E_ij = exp(D~_ij - m_i) (0 above
    the diagonal), W = C E, σ_i = Σ_j W_ij, |n_i| = max(|σ_i|, exp(-m_i),
    1e-30), a_i = [|n_i| > max(exp(-m_i), 1e-30)], sign(σ_i) = sign(n_i)
    where a_i, and δ_i = dh_i·h_i:
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
    m = m.float()
    E = torch.exp(Dt - m[..., None])
    W = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale * E
    n = n.float()
    c = torch.where(n.abs() > _floor(m), torch.sign(n) * (gf * hf).sum(dim=-1), 0.0)
    n = n.abs()
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
