"""Attention mixers: the dense GQA family — full, sliding-window (swa) and
chunked-local (cla) — and MLA, for prefill and for decode over a KV cache
(port of `repro.models.attention`).

The two contract functions of the reference — `chunked_attention` (prefill)
and `decode_attention` (decode) — run the hand-written CUDA kernels on the
card (`kernels.flash_attention.ops.mha`, `kernels.decode_attention.ops.decode`)
and their plain versions on CPU tensors. Decode caches:
  * full attention  — linear cache [B, S, kv, hd]
  * swa / cla       — ring-buffer cache [B, window, kv, hd]  (bounded state)
  * mla             — compressed latent cache c_kv [B, S, kv_lora] and
                      k_rope [B, S, rope_dim] (linear)
  * int8 (`kv_cache_dtype="int8"`) — the gqa / swa / cla caches as int8
                      with float32 scales k_scale / v_scale [B, cap, kv], one
                      per (token, head); the decode kernel reads them as int8
  * cross           — an encoder-decoder's cross K/V over the encoder's
                      frames [B, M, kv, hd], every slot valid (M = 0: an
                      empty memory, whose attention is zeros)

Both kernels cap the scaled scores at `tanh(s / cap) * cap` before the
mask when `logit_cap > 0` (recurrentgemma's `attn_softcap`), as the
reference does. MLA's prefill goes through the flash kernel with V heads
narrower than its Q/K heads (64 vs 96 at minicpm3-4b); its absorbed decode
is plain products, as in the reference. A model with `cfg.irope` (llama4)
takes no RoPE on its global `gqa` layers. Cross-attention (no RoPE, no
bias) runs its prefill through the flash kernel with a key length of its
own, and its decode step through the decode kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import kv_dequantize
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, rmsnorm


def chunked_attention(q, k, v, *, causal=True, window=0, chunk_local=False, logit_cap=0.0):
    """q: [B,S,H,dh], k: [B,Sk,KV,dh], v: [B,Sk,KV,dv] (dv <= dh) -> [B,S,H,dv].

    window > 0: sliding-window (swa) or same-chunk (cla when chunk_local)
    mask. The kernel skips key blocks the mask empties, so a windowed layer
    reads only the band it needs, as the reference's band slicing does.
    Sk != S (cross-attention) needs causal=False and no window."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal attention needs q_len == kv_len")
    return flash_ops.mha(q, k, v, causal=causal, window=window, chunk_local=chunk_local,
                         logit_cap=logit_cap)


def decode_attention(q, k_cache, v_cache, valid, *, logit_cap=0.0, k_scale=None, v_scale=None):
    """Single-position decode. q: [B,1,H,dh]; caches [B,Sc,KV,dh] in q's
    dtype, or int8 with float32 scales [B,Sc,KV]; valid: [B,Sc] bool —
    which cache slots participate. -> [B,1,H,dh]."""
    scales = {} if k_scale is None else {"k_scale": k_scale, "v_scale": v_scale}
    return decode_ops.decode(q, k_cache, v_cache, valid, logit_cap=logit_cap, **scales)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) with w cast to x's dtype."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(*x.shape[:2], *w.shape[1:])


def use_rope(cfg, mixer: str) -> bool:
    """iRoPE: a model with `cfg.irope` (llama4) takes no RoPE on its global
    (`gqa`) layers; the reference tests the name for the same rule."""
    return not (cfg.irope and mixer == "gqa")


def gqa_project_qkv(cfg, p, prefix, x, positions, rope=True):
    q = _proj(x, p[f"{prefix}.wq"])
    k = _proj(x, p[f"{prefix}.wk"])
    v = _proj(x, p[f"{prefix}.wv"])
    if cfg.qkv_bias:
        q = q + p[f"{prefix}.bq"].to(x.dtype)
        k = k + p[f"{prefix}.bk"].to(x.dtype)
        v = v + p[f"{prefix}.bv"].to(x.dtype)
    if rope:
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
    q, k, v = gqa_project_qkv(cfg, p, prefix, x, positions, use_rope(cfg, mixer))
    o = chunked_attention(
        q, k, v, causal=causal, window=window, chunk_local=(mixer == "cla"),
        logit_cap=cfg.attn_softcap,
    )
    return _out_proj(o, p[f"{prefix}.wo"]), (k, v)


def _kv_quantize(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization, the reference's
    `_kv_quantize`: x [..., hd] -> (int8 [..., hd], float32 scale [...]).
    scale = max(max|x| / 127, 1e-8); q = clip(round(x / scale), -127, 127),
    rounding half to even as `jnp.round` does and dividing (not multiplying
    by 1 / scale), so equal inputs give the reference's bits."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


# the reference's `_kv_dequantize` (q8 [B,S,KV,hd], scale [B,S,KV] -> the
# float32 product in `dtype`); the decode kernel does the same on load
_kv_dequantize = kv_dequantize


def gqa_decode(cfg, p, prefix, x, pos, cache, *, mixer: str):
    """One-token decode step. cache: dict(k, v) of [B,Sc,KV,hd] views, ring
    buffers for swa/cla; with `kv_cache_dtype="int8"` k and v are int8 and
    dict(k_scale, v_scale) holds their float32 scales [B,Sc,KV]. The new key
    and value (quantized, for int8) are written into the cache IN PLACE (the
    reference returns new arrays); the returned dict holds the same
    tensors. The decode kernel reads an int8 cache as it is, dequantizing
    as it loads (the reference dequantizes the whole cache to bf16 first:
    the same values)."""
    B = x.shape[0]
    q, k, v = gqa_project_qkv(cfg, p, prefix, x, pos[:, None], use_rope(cfg, mixer))
    k_cache, v_cache = cache["k"], cache["v"]
    Sc = k_cache.shape[1]
    slot = (pos % Sc).long()  # ring position (== pos for linear caches, Sc >= max_seq)
    bidx = torch.arange(B, device=x.device)
    scales = {}
    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k), ("v", v)):
            q8, sc = _kv_quantize(new[:, 0])
            cache[name][bidx, slot] = q8
            cache[f"{name}_scale"][bidx, slot] = sc
            scales[f"{name}_scale"] = cache[f"{name}_scale"]
    else:
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
    o = decode_attention(q, k_cache, v_cache, valid, logit_cap=cfg.attn_softcap, **scales)
    return _out_proj(o, p[f"{prefix}.wo"]), cache


# ---------------------------------------------------------------------------
# cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attn(cfg, p, prefix, x, enc_out):
    """Encoder-decoder cross-attention at prefill (full, no RoPE on the
    memory, no bias): x [B,S,D] against enc_out [B,M,D]. Returns (out,
    (k, v)): the memory's K/V [B,M,KV,hd], position-independent, which the
    decode cache keeps (the reference computes the same product twice)."""
    q = _proj(x, p[f"{prefix}.wq"])
    k = _proj(enc_out, p[f"{prefix}.wk"])
    v = _proj(enc_out, p[f"{prefix}.wv"])
    o = chunked_attention(q, k, v, causal=False)
    return _out_proj(o, p[f"{prefix}.wo"]), (k, v)


def cross_decode(cfg, p, prefix, x, xk, xv):
    """One decode step's cross-attention: x [B,1,D] against the cached
    memory K/V [B,M,KV,hd], every slot valid. M = 0 (the router's empty
    memory) gives zeros, as the reference's softmax over no slots does."""
    q = _proj(x, p[f"{prefix}.wq"])
    valid = torch.ones((x.shape[0], xk.shape[1]), dtype=torch.bool, device=x.device)
    return _out_proj(decode_attention(q, xk, xv, valid), p[f"{prefix}.wo"])


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2)
# ---------------------------------------------------------------------------


def _mla_q(cfg, p, prefix, x, positions):
    cq = rmsnorm(x @ p[f"{prefix}.wq_a"].to(x.dtype), p[f"{prefix}.q_norm"])
    q = _proj(cq, p[f"{prefix}.wq_b"])  # [B,S,H,nope+rope]
    q_rope = apply_rope(q[..., cfg.nope_head_dim :], positions, cfg.rope_theta)
    return q[..., : cfg.nope_head_dim], q_rope


def _mla_latent(cfg, p, prefix, x, positions):
    ckv = x @ p[f"{prefix}.wkv_a"].to(x.dtype)
    c_kv = rmsnorm(ckv[..., : cfg.kv_lora_rank], p[f"{prefix}.kv_norm"])
    k_rope = apply_rope(ckv[..., None, cfg.kv_lora_rank :], positions, cfg.rope_theta)
    return c_kv, k_rope  # [B,S,kv_lora], [B,S,1,rope]


def mla_attn(cfg, p, prefix, x, positions):
    """Prefill MLA (direct form): per-head K = [W_uk c_kv, k_rope] and V =
    W_uv c_kv, through the flash kernel with dh = nope + rope and dv = v_hd.
    Returns (out, (c_kv, k_rope)) — the compressed cache's contents."""
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, prefix, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, prefix, x, positions)
    kv = _proj(c_kv, p[f"{prefix}.wkv_b"])  # [B,S,H,nope+v]
    k = torch.cat([kv[..., : cfg.nope_head_dim],
                   k_rope.expand(B, S, H, cfg.rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = chunked_attention(q, k, kv[..., cfg.nope_head_dim :], causal=True)
    return _out_proj(o, p[f"{prefix}.wo"]), (c_kv, k_rope[:, :, 0])


def mla_decode(cfg, p, prefix, x, pos, cache):
    """Absorbed-matrix MLA decode over the compressed cache dict(c_kv
    [B,Sc,kv_lora], k_rope [B,Sc,rope]), written IN PLACE at `pos`:

      score_h = (W_uk_h^T q_nope_h) . c_kv + q_rope_h . k_rope

    the two score products summed in x's dtype, then float32 x
    (nope + rope)^-0.5, the `valid` mask's finite -1e30, softmax, and
    (P . c_kv) W_uv — plain products, as in the reference."""
    B = x.shape[0]
    nope = cfg.nope_head_dim
    q_nope, q_rope = _mla_q(cfg, p, prefix, x, pos[:, None])  # [B,1,H,*]
    c_new, kr_new = _mla_latent(cfg, p, prefix, x, pos[:, None])
    ckv, kr = cache["c_kv"], cache["k_rope"]
    Sc = ckv.shape[1]
    bidx, slot = torch.arange(B, device=x.device), pos.long()
    ckv[bidx, slot] = c_new[:, 0].to(ckv.dtype)
    kr[bidx, slot] = kr_new[:, 0, 0].to(kr.dtype)
    wkv_b = p[f"{prefix}.wkv_b"].to(x.dtype)  # [r,H,nope+v]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], wkv_b[..., :nope])  # absorbed q
    s = torch.einsum("bhr,bsr->bhs", q_lat, ckv) + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], kr)
    s = s.float() * (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    valid = torch.arange(Sc, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhr,rhk->bhk", torch.einsum("bhs,bsr->bhr", pr, ckv), wkv_b[..., nope:])
    wo = p[f"{prefix}.wo"].to(x.dtype)
    return (o.reshape(B, -1) @ wo.reshape(-1, wo.shape[-1]))[:, None], cache
