"""Plain PyTorch version of the flash-attention kernel: a straight
translation of `repro.kernels.flash_attention.ref.attention_ref`. It
materializes the full score matrix. The CPU path of the wrapper, and what
`chip_smoke.py` holds the CUDA kernel against."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=0, chunk_local=False, logit_cap=0.0):
    """q: [B,H,Sq,dh], k: [B,KV,Sk,dh], v: [B,KV,Sk,dv] (dv <= dh) -> [B,H,Sq,dv]
    (float32 math; the scale is dh^-0.5). Sq != Sk is cross-attention, which
    the callers run without the causal and window masks. `logit_cap` > 0 caps
    the scaled scores before the mask (`repro.models.layers.softcap`)."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    G = H // k.shape[1]
    qf = q.float()
    kf = torch.repeat_interleave(k.float(), G, dim=1)
    vf = torch.repeat_interleave(v.float(), G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (dh**-0.5)
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        if chunk_local:
            mask &= (kpos // window) == (qpos // window)
        else:
            mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
