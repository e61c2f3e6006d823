"""Plain PyTorch version of the decode-attention kernel: a straight
translation of `repro.kernels.decode_attention.ref.decode_ref`, and of the
reference model's int8 cache read (`_kv_dequantize`, then the same
attention). The CPU path of the wrapper, and what `chip_smoke.py` holds
the CUDA kernel against."""

from __future__ import annotations

import torch


def decode_ref(q, k_cache, v_cache, valid, *, logit_cap=0.0):
    """q: [B,H,dh]; caches [B,Sc,KV,dh]; valid: [B,Sc] bool -> [B,H,dh].
    `logit_cap` > 0 caps the scaled scores before the mask. Sc = 0 gives
    zeros (an empty sum), as the reference's does."""
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


def kv_dequantize(q8, scale, dtype):
    """The reference's `_kv_dequantize`: q8 [..., hd] int8, scale [...]
    float32 -> the float32 product rounded to `dtype`."""
    return (q8.float() * scale[..., None]).to(dtype)


def decode_int8_ref(q, k_cache, v_cache, k_scale, v_scale, valid, *, logit_cap=0.0):
    """`decode_ref` over an int8 cache [B,Sc,KV,dh] with float32 scales
    [B,Sc,KV], dequantized to q's dtype first (the reference model's
    `gqa_decode` with `kv_cache_dtype="int8"`)."""
    return decode_ref(q, kv_dequantize(k_cache, k_scale, q.dtype),
                      kv_dequantize(v_cache, v_scale, q.dtype), valid, logit_cap=logit_cap)
