"""Attention mixers of the dense GQA family: full, sliding-window (swa) and
chunked-local (cla), for prefill and for decode over a KV cache (port of
`repro.models.attention`).

The two contract functions of the reference — `chunked_attention` (prefill)
and `decode_attention` (decode) — run the hand-written CUDA kernels on the
card (`kernels.flash_attention.ops.mha`, `kernels.decode_attention.ops.decode`)
and their plain versions on CPU tensors. Decode caches:
  * full attention  — linear cache [B, S, kv, hd]
  * swa / cla       — ring-buffer cache [B, window, kv, hd]  (bounded state)

Both kernels cap the scaled scores at `tanh(s / cap) * cap` before the
mask when `logit_cap > 0` (recurrentgemma's `attn_softcap`), as the
reference does. The int8-quantized cache, MLA and cross-attention raise
(ROADMAP.md §A item A9).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope
from repro_torch.unported import not_ported


def chunked_attention(q, k, v, *, causal=True, window=0, chunk_local=False, logit_cap=0.0):
    """q: [B,S,H,dh], k/v: [B,S,KV,dh] -> [B,S,H,dh].

    window > 0: sliding-window (swa) or same-chunk (cla when chunk_local)
    mask. The kernel skips key blocks the mask empties, so a windowed layer
    reads only the band it needs, as the reference's band slicing does."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal attention needs q_len == kv_len")
    return flash_ops.mha(q, k, v, causal=causal, window=window, chunk_local=chunk_local,
                         logit_cap=logit_cap)


def decode_attention(q, k_cache, v_cache, valid, *, logit_cap=0.0):
    """Single-position decode. q: [B,1,H,dh]; caches [B,Sc,KV,dh];
    valid: [B,Sc] bool — which cache slots participate."""
    return decode_ops.decode(q, k_cache, v_cache, valid, logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) with w cast to x's dtype."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(*x.shape[:2], *w.shape[1:])


def gqa_project_qkv(cfg, p, prefix, x, positions):
    q = _proj(x, p[f"{prefix}.wq"])
    k = _proj(x, p[f"{prefix}.wk"])
    v = _proj(x, p[f"{prefix}.wv"])
    if cfg.qkv_bias:
        q = q + p[f"{prefix}.bq"].to(x.dtype)
        k = k + p[f"{prefix}.bk"].to(x.dtype)
        v = v + p[f"{prefix}.bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o, wo):
    """einsum("bshk,hkd->bsd", o, wo) with wo cast to o's dtype."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.to(o.dtype).reshape(-1, wo.shape[-1])


def gqa_attn(cfg, p, prefix, x, positions, *, mixer: str, causal=True):
    """Prefill GQA. Returns (out, (k, v)) — k/v for cache construction."""
    window = cfg.window if mixer in ("swa", "cla") else 0
    q, k, v = gqa_project_qkv(cfg, p, prefix, x, positions)
    o = chunked_attention(
        q, k, v, causal=causal, window=window, chunk_local=(mixer == "cla"),
        logit_cap=cfg.attn_softcap,
    )
    return _out_proj(o, p[f"{prefix}.wo"]), (k, v)


def gqa_decode(cfg, p, prefix, x, pos, cache, *, mixer: str):
    """One-token decode step. cache: dict(k, v) of [B,Sc,KV,hd] views, ring
    buffers for swa/cla. The new key and value are written into the cache
    IN PLACE (the reference returns new arrays); the returned dict holds the
    same tensors."""
    if cfg.kv_cache_dtype != "bf16":
        raise not_ported(f"the {cfg.kv_cache_dtype} KV cache", "A9")
    B = x.shape[0]
    q, k, v = gqa_project_qkv(cfg, p, prefix, x, pos[:, None])
    k_cache, v_cache = cache["k"], cache["v"]
    Sc = k_cache.shape[1]
    slot = (pos % Sc).long()  # ring position (== pos for linear caches, Sc >= max_seq)
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    slots = torch.arange(Sc, device=x.device)[None, :]
    if mixer == "cla":
        # ring slot s holds absolute position chunk_start + s only when
        # s <= pos % window; later slots are stale previous-chunk entries
        valid = slots <= slot[:, None]
    else:
        # full (linear) and swa (ring): every written slot participates
        valid = slots <= pos[:, None]
    o = decode_attention(q, k_cache, v_cache, valid, logit_cap=cfg.attn_softcap)
    return _out_proj(o, p[f"{prefix}.wo"]), cache
