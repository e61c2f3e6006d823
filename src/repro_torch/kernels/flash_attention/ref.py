"""Plain PyTorch version of the flash-attention kernel: a straight
translation of `repro.kernels.flash_attention.ref.attention_ref`. It
materializes the full score matrix. The CPU path of the wrapper, and what
`chip_smoke.py` holds the CUDA kernel against; `attention_bwd_ref` is the
plain version of the backward kernel."""

from __future__ import annotations

import torch


def _mask(Sq, Sk, causal, window, chunk_local, device):
    """[Sq, Sk] bool: the pairs the forward attends to."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        if chunk_local:
            mask &= (kpos // window) == (qpos // window)
        else:
            mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, chunk_local=False, logit_cap=0.0,
                  with_lse=False):
    """q: [B,H,Sq,dh], k: [B,KV,Sk,dh], v: [B,KV,Sk,dv] (dv <= dh) -> [B,H,Sq,dv]
    (float32 math; the scale is dh^-0.5). Sq != Sk is cross-attention, which
    the callers run without the causal and window masks. `logit_cap` > 0 caps
    the scaled scores before the mask (`repro.models.layers.softcap`).
    `with_lse`: also return each row's log-sum-exp of its masked, capped
    scores, float32 [B,H,Sq] (what the forward kernel writes for the
    backward)."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    G = H // k.shape[1]
    qf = q.float()
    kf = torch.repeat_interleave(k.float(), G, dim=1)
    vf = torch.repeat_interleave(v.float(), G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (dh**-0.5)
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = torch.where(_mask(Sq, Sk, causal, window, chunk_local, q.device), s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_bwd_ref(q, k, v, o, dout, lse, *, causal=True, window=0, chunk_local=False,
                      logit_cap=0.0):
    """The gradient of `attention_ref` in the FA2 form the CUDA backward
    computes, in float32: P recomputed from the scores and the forward's
    row log-sum-exp `lse` [B,H,Sq] (`attention_ref(..., with_lse=True)`),
    D = rowsum(dO ∘ O) from the forward's output `o`, dV = Pᵀ·dO,
    dS = P ∘ (dO·Vᵀ - D) (times 1 - tanh² under the cap), dQ = dS·K·scale,
    dK = dSᵀ·Q·scale, dK and dV summed over each KV head's query heads.
    q [B,H,Sq,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dout [B,H,Sq,dv]
    -> (dq, dk, dv) in q's dtype."""
    B, H, Sq, dh = q.shape
    KV, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = dh**-0.5
    qf, of, gf = q.float(), o.float(), dout.float()
    kf = torch.repeat_interleave(k.float(), G, dim=1)
    vf = torch.repeat_interleave(v.float(), G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    t = None
    if logit_cap > 0:
        t = torch.tanh(s / logit_cap)
        s = t * logit_cap
    mask = _mask(Sq, Sk, causal, window, chunk_local, q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    delta = (gf * of).sum(-1, keepdim=True)
    dv_full = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - delta)
    if t is not None:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk_full = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk_ = dk_full.reshape(B, KV, G, Sk, dh).sum(2)
    dv_ = dv_full.reshape(B, KV, G, Sk, dv).sum(2)
    return dq.to(q.dtype), dk_.to(k.dtype), dv_.to(v.dtype)
