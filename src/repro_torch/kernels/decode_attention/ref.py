"""Plain PyTorch version of the decode-attention kernel: a straight
translation of `repro.kernels.decode_attention.ref.decode_ref`. The CPU path
of the wrapper, and what `chip_smoke.py` holds the CUDA kernel against."""

from __future__ import annotations

import torch


def decode_ref(q, k_cache, v_cache, valid, *, logit_cap=0.0):
    """q: [B,H,dh]; caches [B,Sc,KV,dh]; valid: [B,Sc] bool -> [B,H,dh].
    `logit_cap` > 0 caps the scaled scores before the mask."""
    B, H, dh = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, dh).float()
    s = torch.einsum("bngd,bsnd->bngs", qf, k_cache.float()) * (dh**-0.5)
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngs,bsnd->bngd", p, v_cache.float())
    return o.reshape(B, H, dh).to(q.dtype)
