"""Model stack: declarative parameter schema + the serving forward passes
(port of `repro.models.stack`).

Layers are stacked by pattern *group*: a config with pattern period P and
n_layers = G*P (+ tail) stores each pattern slot's weights as [G, ...]
tensors. The reference scans over G (`jax.lax.scan`); the port loops over the
stacked tensors in Python, taking one layer's weights and cache as views
(no copies). Parameter names, the [G, ...] stacking and the cache layout
(``{"blk0": {"k": [G,B,Sc,KV,hd], "v": ...}}``) are the reference's, so
weights and caches carry across as they are (`repro_torch.interop`).

Three entry points:
  forward_train(cfg, params, batch, remat=False)  -> logits
  forward_prefill(cfg, params, batch, cache_len) -> (last_logits, cache)
  forward_decode(cfg, params, token, pos, cache) -> (logits, cache)
Decode writes the new key and value, and the recurrent mixers' new states,
into `cache` IN PLACE and returns it. `forward_train` keeps no cache and
writes nothing in place; it casts every weight inside the autograd graph on
each call (the reference's `astype`), so its gradients reach the float32
parameters: `cast_weights`' copies are for serving only.

`build_schema` and the forward passes cover all ten architectures: the
dense GQA family (mixers gqa / swa / cla, logit softcapping), MLA
(minicpm3-4b; its compressed latent cache), the dense and MoE FFNs
(mixtral-8x7b, llama4-scout with iRoPE), the recurrent mixers (mlstm /
slstm of xLSTM, rglru of RecurrentGemma, whose states are float32 leaves
beside bf16 conv buffers), the vision frontend (internvl2-26b: patch
embeddings projected by `frontend_proj` ahead of the tokens), the
encoder-decoder with its audio frontend (seamless-m4t: a non-causal
encoder over the projected frames, cross-attention in every decoder
layer, whose cache holds the memory's K/V beside the self-attention's) and
the int8 KV cache (`kv_cache_dtype="int8"`: int8 K/V and float32 scales).
On the card a training forward runs through the attention, mLSTM and
RG-LRU kernels, and its gradient through their hand-written backwards
(each wrapper an autograd Function), so every family trains there; on the
CPU the same Functions run the plain versions and their plain backwards.

The prefill batch: {"tokens"}; a vision model {"patches" [B,P,frontend_dim],
"tokens"} (positions 0..P+T-1 over both); an encoder-decoder
{"frames" [B,M,frontend_dim], "dec_tokens"}.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_lookup, ffn, rmsnorm
from repro_torch.models.schema import ParamSpec, Schema

# the activations' dtype, as in the reference: embeddings are looked up in it
# and every product casts its weights to it
ACT_DTYPE = torch.bfloat16

# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


def _attn_schema(cfg: ModelConfig, pfx: str) -> Schema:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        f"{pfx}.ln": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wq": ParamSpec((D, H, hd), ("embed", "heads", None), f"scaled:{D}"),
        f"{pfx}.wk": ParamSpec((D, KV, hd), ("embed", "kv", None), f"scaled:{D}"),
        f"{pfx}.wv": ParamSpec((D, KV, hd), ("embed", "kv", None), f"scaled:{D}"),
        f"{pfx}.wo": ParamSpec((H, hd, D), ("heads", None, "embed"), f"scaled:{H*hd}"),
    }
    if cfg.qkv_bias:
        s[f"{pfx}.bq"] = ParamSpec((H, hd), ("heads", None), "zeros")
        s[f"{pfx}.bk"] = ParamSpec((KV, hd), ("kv", None), "zeros")
        s[f"{pfx}.bv"] = ParamSpec((KV, hd), ("kv", None), "zeros")
    return s


def _mla_schema(cfg: ModelConfig, pfx: str) -> Schema:
    D, H = cfg.d_model, cfg.n_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    return {
        f"{pfx}.ln": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wq_a": ParamSpec((D, cfg.q_lora_rank), ("embed", None), f"scaled:{D}"),
        f"{pfx}.q_norm": ParamSpec((cfg.q_lora_rank,), (None,), "zeros"),
        f"{pfx}.wq_b": ParamSpec(
            (cfg.q_lora_rank, H, qk), (None, "heads", None), f"scaled:{cfg.q_lora_rank}"
        ),
        f"{pfx}.wkv_a": ParamSpec(
            (D, cfg.kv_lora_rank + cfg.rope_head_dim), ("embed", None), f"scaled:{D}"
        ),
        f"{pfx}.kv_norm": ParamSpec((cfg.kv_lora_rank,), (None,), "zeros"),
        f"{pfx}.wkv_b": ParamSpec(
            (cfg.kv_lora_rank, H, cfg.nope_head_dim + cfg.v_hd),
            (None, "heads", None),
            f"scaled:{cfg.kv_lora_rank}",
        ),
        f"{pfx}.wo": ParamSpec(
            (H, cfg.v_hd, D), ("heads", None, "embed"), f"scaled:{H*cfg.v_hd}"
        ),
    }


def _mlstm_schema(cfg: ModelConfig, pfx: str) -> Schema:
    D, H = cfg.d_model, cfg.n_heads
    return {
        f"{pfx}.ln": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wu": ParamSpec((D, 2 * D), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.conv": ParamSpec((4, D), (None, None), f"scaled:4"),
        f"{pfx}.wq": ParamSpec((D, D), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.wk": ParamSpec((D, D), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.wv": ParamSpec((D, D), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.wi": ParamSpec((D, H), ("embed", None), f"scaled:{D}"),
        f"{pfx}.wf": ParamSpec((D, H), ("embed", None), f"scaled:{D}"),
        f"{pfx}.bi": ParamSpec((H,), (None,), "zeros"),
        f"{pfx}.bf": ParamSpec((H,), (None,), "ones"),
        f"{pfx}.mn": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wd": ParamSpec((D, D), ("mlp", "embed"), f"scaled:{D}"),
    }


def _slstm_schema(cfg: ModelConfig, pfx: str) -> Schema:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    return {
        f"{pfx}.ln": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wzifo": ParamSpec((D, 4 * D), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.bzifo": ParamSpec((4 * D,), ("mlp",), "zeros"),
        f"{pfx}.r": ParamSpec(
            (4, H, dh, dh), (None, "heads", None, None), f"scaled:{dh}"
        ),
        f"{pfx}.mn": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wd": ParamSpec((D, D), ("mlp", "embed"), f"scaled:{D}"),
    }


def _rglru_schema(cfg: ModelConfig, pfx: str) -> Schema:
    D = cfg.d_model
    E = int(cfg.rnn_scale * D)
    return {
        f"{pfx}.ln": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wgate": ParamSpec((D, E), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.wx": ParamSpec((D, E), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.conv": ParamSpec((cfg.rglru_conv_width, E), (None, "mlp"), "scaled:4"),
        f"{pfx}.wa": ParamSpec((E, E), ("embed", "mlp"), f"scaled:{E}"),
        f"{pfx}.wi": ParamSpec((E, E), ("embed", "mlp"), f"scaled:{E}"),
        f"{pfx}.ba": ParamSpec((E,), ("mlp",), "ones"),
        f"{pfx}.bi": ParamSpec((E,), ("mlp",), "zeros"),
        f"{pfx}.lam": ParamSpec((E,), ("mlp",), "ones"),
        f"{pfx}.wout": ParamSpec((E, D), ("mlp", "embed"), f"scaled:{E}"),
    }


def _ffn_schema(cfg: ModelConfig, pfx: str, kind: str) -> Schema:
    D, F = cfg.d_model, cfg.d_ff
    if kind == "none":
        return {}
    if kind == "moe":
        E = cfg.n_experts
        return {
            f"{pfx}.ln2": ParamSpec((D,), ("embed",), "zeros"),
            f"{pfx}.router": ParamSpec((D, E), ("embed", None), f"scaled:{D}"),
            f"{pfx}.we_g": ParamSpec(
                (E, D, F), ("experts", "embed", "mlp"), f"scaled:{D}"
            ),
            f"{pfx}.we_u": ParamSpec(
                (E, D, F), ("experts", "embed", "mlp"), f"scaled:{D}"
            ),
            f"{pfx}.we_d": ParamSpec(
                (E, F, D), ("experts", "mlp", "embed"), f"scaled:{F}"
            ),
        }
    return {
        f"{pfx}.ln2": ParamSpec((D,), ("embed",), "zeros"),
        f"{pfx}.wg": ParamSpec((D, F), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.wu": ParamSpec((D, F), ("embed", "mlp"), f"scaled:{D}"),
        f"{pfx}.wd": ParamSpec((F, D), ("mlp", "embed"), f"scaled:{F}"),
    }


_MIXER_SCHEMA = {
    "gqa": _attn_schema,
    "swa": _attn_schema,
    "cla": _attn_schema,
    "mla": _mla_schema,
    "mlstm": _mlstm_schema,
    "slstm": _slstm_schema,
    "rglru": _rglru_schema,
}


def _layer_schema(cfg: ModelConfig, pfx: str, mixer: str, ffn_kind: str, cross: bool) -> Schema:
    s = dict(_MIXER_SCHEMA[mixer](cfg, f"{pfx}.mix"))
    s.update(_ffn_schema(cfg, f"{pfx}.ffn", ffn_kind))
    if cross:
        s.update(_attn_schema(cfg, f"{pfx}.x"))
        # cross-attention has no qkv bias regardless of cfg
        for b in (f"{pfx}.x.bq", f"{pfx}.x.bk", f"{pfx}.x.bv"):
            s.pop(b, None)
    return s


def _stack(s: Schema, g: int) -> Schema:
    return {
        n: ParamSpec((g,) + sp.shape, ("layers",) + sp.axes, sp.init, sp.dtype)
        for n, sp in s.items()
    }


def tail_layers(cfg: ModelConfig) -> tuple:
    tail = getattr(cfg, "tail", ())
    return tuple(tail)


def n_groups(cfg: ModelConfig) -> int:
    tail = tail_layers(cfg)
    if (cfg.n_layers - len(tail)) % cfg.period:
        raise ValueError(f"{cfg.name}: n_layers - len(tail) is not a multiple of the period")
    return (cfg.n_layers - len(tail)) // cfg.period


def build_schema(cfg: ModelConfig) -> Schema:
    s: Schema = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "final_ln": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec(
            (cfg.d_model, cfg.vocab), ("embed", "vocab"), f"scaled:{cfg.d_model}"
        )
    if cfg.frontend != "none":
        s["frontend_proj"] = ParamSpec(
            (cfg.frontend_dim, cfg.d_model), (None, "embed"), f"scaled:{cfg.frontend_dim}"
        )
    G = n_groups(cfg)
    cross = cfg.is_encdec
    for j, (mixer, fk) in enumerate(cfg.pattern):
        s.update(_stack(_layer_schema(cfg, f"blk{j}", mixer, fk, cross), G))
    for i, (mixer, fk) in enumerate(tail_layers(cfg)):
        s.update(_layer_schema(cfg, f"tail{i}", mixer, fk, cross))
    if cfg.is_encdec:
        enc = _layer_schema(cfg, "eblk0", "gqa", "dense", False)
        s.update(_stack(enc, cfg.n_enc_layers))
        s["enc_final_ln"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return s


# ---------------------------------------------------------------------------
# what the serving path runs
# ---------------------------------------------------------------------------

_ATTN = ("gqa", "swa", "cla")
_MLA = ("mla",)
_RECURRENT = ("mlstm", "slstm", "rglru")


def check_supported(cfg: ModelConfig) -> None:
    """Raise `ValueError` for a mixer, frontend or cache type `cfg` names
    that the model family does not have (every registry config passes)."""
    for mixer, _ in tuple(cfg.pattern) + tail_layers(cfg):
        if mixer not in _ATTN + _MLA + _RECURRENT:
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")
    if cfg.frontend not in ("none", "vision", "audio"):
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
    if cfg.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"{cfg.name}: unknown KV cache dtype {cfg.kv_cache_dtype!r}")


# the weights each mixer's products cast to the activations' dtype; the rest
# (norm scales, MLA's q_norm / kv_norm among them; rglru's gate weights wa,
# wi, ba, bi, lam; slstm's recurrent r) are read as float32, so the same
# name (wi, bi) casts in one mixer and not in another
_ATTN_CAST = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MIX_CAST = {
    **{m: _ATTN_CAST for m in _ATTN},
    "mla": ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"),
    "mlstm": ("wu", "conv", "wq", "wk", "wv", "wi", "wf", "bi", "bf", "wd"),
    "slstm": ("wzifo", "bzifo", "wd"),
    "rglru": ("wgate", "wx", "conv", "wout"),
}
_FFN_CAST = ("wg", "wu", "wd", "router", "we_g", "we_u", "we_d")  # dense, then MoE


def cast_weights(cfg: ModelConfig, params: dict) -> dict:
    """Copies of the weights every product casts to the activations' dtype
    (`astype(x.dtype)` in the reference, `ACT_DTYPE` here) made once, so a
    forward does not re-cast them (6.4 GB of writes a forward at
    llama3.2-3b). Casting is round-to-nearest-even in both frameworks, so
    the values are bitwise those of a per-call cast. Which weights cast is
    decided per mixer (`_MIX_CAST`; the encoder's `eblk0` layers are gqa, a
    decoder layer's cross-attention `x` casts as gqa does); the others are
    shared, not copied. `params` may hold any subset of the schema's names."""
    mixers = {f"blk{j}": mixer for j, (mixer, _) in enumerate(cfg.pattern)}
    mixers.update({f"tail{i}": mixer for i, (mixer, _) in enumerate(tail_layers(cfg))})
    mixers["eblk0"] = "gqa"
    out = {}
    for name, w in params.items():
        parts = name.split(".")
        if len(parts) == 3 and parts[1] == "mix":
            cast = parts[2] in _MIX_CAST.get(mixers.get(parts[0]), ())
        elif len(parts) == 3 and parts[1] == "ffn":
            cast = parts[2] in _FFN_CAST
        elif len(parts) == 3 and parts[1] == "x":
            cast = parts[2] in _ATTN_CAST
        else:
            cast = name in ("embed", "lm_head", "frontend_proj")
        out[name] = w.to(ACT_DTYPE) if cast else w
    return out


def _layer(params: dict, pfx: str, g: int | None) -> dict:
    """One layer's weights: views `[g]` of the stacked tensors (or the tail's)."""
    return {
        k: (v if g is None else v[g]) for k, v in params.items() if k.startswith(pfx + ".")
    }


def _layers(cfg: ModelConfig):
    """(prefix, stacked index or None, mixer, ffn kind) in forward order."""
    for g in range(n_groups(cfg)):
        for j, (mixer, fk) in enumerate(cfg.pattern):
            yield f"blk{j}", g, mixer, fk
    for i, (mixer, fk) in enumerate(tail_layers(cfg)):
        yield f"tail{i}", None, mixer, fk


def _views(tree: dict, g: int | None) -> dict:
    """The nested dict `tree` with every leaf viewed at `[g]` (no copies)."""
    return {k: _views(v, g) if isinstance(v, dict) else (v if g is None else v[g])
            for k, v in tree.items()}


def _layer_cache(cache: dict, pfx: str, g: int | None) -> dict:
    """One layer's cache: views of the stacked leaves, so writes reach `cache`."""
    return _views(cache[pfx], g)


def _write_state(dst: dict, src: dict) -> None:
    """Copy a recurrent mixer's new state (nested dict) into its cache views."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_state(dst[k], v)
        else:
            dst[k].copy_(v)


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head", None)
    if head is None:
        head = params["embed"].T
    return x @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def _train_layer(cfg, p, pfx, mixer, fk, x, positions, enc_out=None):
    """One decoder layer of the training forward: `_prefill_layer`'s mixers
    without a cache (an encoder-decoder's cross-attention after the mixer)."""
    if mixer in _RECURRENT:
        y, _ = _RECURRENT_BLOCK[mixer](cfg, p, pfx + ".mix", x)
    else:
        xn = rmsnorm(x, p[f"{pfx}.mix.ln"])
        if mixer in _MLA:
            y, _ = attn.mla_attn(cfg, p, pfx + ".mix", xn, positions)
        else:
            y, _ = attn.gqa_attn(cfg, p, pfx + ".mix", xn, positions, mixer=mixer)
    x = x + y
    if enc_out is not None:
        xn = rmsnorm(x, p[f"{pfx}.x.ln"])
        x = x + attn.cross_attn(cfg, p, f"{pfx}.x", xn, enc_out)[0]
    if fk != "none":
        xn = rmsnorm(x, p[f"{pfx}.ffn.ln2"])
        x = x + ffn(cfg, p, f"{pfx}.ffn", fk, xn)
    return x


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the 2-D weight products (`aten.mm`, what
    `x @ w` lowers to), recompute the rest; the counterpart of
    `jax.checkpoint_policies.dots_with_no_batch_dims_saveable` (batched
    products, `bmm`, are recomputed there too)."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_products)


def forward_train(cfg: ModelConfig, params: dict, batch: dict, remat=False) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V] in the activations' dtype.

    batch: {"tokens" [B,S]}; a vision model's {"patches", "tokens"} (the
    logits cover the patches too); an encoder-decoder's {"frames",
    "dec_tokens"} (logits over the decoder tokens). Labels are read by the
    loss, not here. remat: False / "none" — no checkpointing; True /
    "full" — `torch.utils.checkpoint` (non-reentrant) around each pattern
    group; "dots" — the same, saving the 2-D weight products and recomputing
    the rest (`_save_products`). The encoder and the tail are not
    checkpointed, as in the reference."""
    check_supported(cfg)
    enc_out = None
    if cfg.is_encdec:
        enc_out = _run_encoder(cfg, params, batch)
        x, positions = _embed_inputs(cfg, params, {"tokens": batch["dec_tokens"]})
    else:
        x, positions = _embed_inputs(cfg, params, batch)

    def group(h, g):
        for j, (mixer, fk) in enumerate(cfg.pattern):
            h = _train_layer(cfg, _layer(params, f"blk{j}", g), f"blk{j}", mixer, fk, h,
                             positions, enc_out)
        return h

    if remat == "dots":
        group = functools.partial(checkpoint, group, use_reentrant=False,
                                  context_fn=_dots_context)
    elif remat and remat != "none":
        group = functools.partial(checkpoint, group, use_reentrant=False)
    for g in range(n_groups(cfg)):
        x = group(x, g)
    for i, (mixer, fk) in enumerate(tail_layers(cfg)):
        x = _train_layer(cfg, _layer(params, f"tail{i}", None), f"tail{i}", mixer, fk, x,
                         positions, enc_out)
    return _head(params, rmsnorm(x, params["final_ln"]))


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def _cache_capacity(cfg: ModelConfig, mixer: str, cache_len: int) -> int:
    if mixer in ("swa", "cla"):
        return min(cfg.window, cache_len)
    return cache_len


def _ring_fill(buf: torch.Tensor, k: torch.Tensor) -> None:
    """Write the last `cap` timesteps of k [B,S,...] into the ring buffer
    `buf` [B,cap,...] at slots absolute-position % cap (in place)."""
    cap, S = buf.shape[1], k.shape[1]
    w = min(cap, S)
    slots = torch.arange(S - w, S, device=k.device) % cap
    buf[:, slots] = k[:, S - w :].to(buf.dtype)


def _seed_to_cache(cfg, mixer, seed, cache: dict, cache_len: int) -> None:
    """Write a prefill's k/v [B,S,KV,hd] (MLA: c_kv [B,S,kv_lora], k_rope
    [B,S,rope]) into one layer's zeroed cache views: a linear cache holds
    positions 0..S-1 then zeros, a ring buffer the last `cap` positions
    (the reference pads / ring-fills new arrays). An int8 cache takes each
    position quantized per (token, head), and its scales beside it, padded
    or ring-filled alike."""
    names = ("c_kv", "k_rope") if mixer in _MLA else ("k", "v")
    if mixer in _ATTN and cfg.kv_cache_dtype == "int8":
        (kq, ks), (vq, vs) = (attn._kv_quantize(x) for x in seed)
        names, seed = ("k", "v", "k_scale", "v_scale"), (kq, vq, ks, vs)
    cap = _cache_capacity(cfg, mixer, cache_len)
    if cap == cache_len:  # linear cache, zero-padded to capacity
        S = seed[0].shape[1]
        if S > cache_len:
            raise ValueError(f"prompt of {S} tokens exceeds cache_len {cache_len}")
        for name, x in zip(names, seed):
            cache[name][:, :S] = x.to(cache[name].dtype)
    else:
        for name, x in zip(names, seed):
            _ring_fill(cache[name], x)


_RECURRENT_BLOCK = {"mlstm": xl.mlstm_block, "slstm": xl.slstm_block, "rglru": rg.rglru_block}


def _prefill_layer(cfg, p, pfx, mixer, fk, x, positions, cache, cache_len, enc_out=None):
    """One decoder layer at prefill, its cache views filled in place. With
    `enc_out` (an encoder-decoder) the layer's cache is {"self": the
    mixer's, "xk", "xv": the memory's cross K/V [B,M,KV,hd]} and a
    cross-attention block follows the mixer."""
    self_cache = cache["self"] if enc_out is not None else cache
    if mixer in _RECURRENT:
        # these blocks norm internally and include their own projections
        y, state = _RECURRENT_BLOCK[mixer](cfg, p, pfx + ".mix", x, return_state=True)
        _write_state(self_cache, state)
    else:
        xn = rmsnorm(x, p[f"{pfx}.mix.ln"])
        if mixer in _MLA:
            y, seed = attn.mla_attn(cfg, p, pfx + ".mix", xn, positions)
        else:
            y, seed = attn.gqa_attn(cfg, p, pfx + ".mix", xn, positions, mixer=mixer)
        _seed_to_cache(cfg, mixer, seed, self_cache, cache_len)
    x = x + y
    if enc_out is not None:
        xn = rmsnorm(x, p[f"{pfx}.x.ln"])
        y, (xk, xv) = attn.cross_attn(cfg, p, f"{pfx}.x", xn, enc_out)
        x = x + y
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
    if fk != "none":
        xn = rmsnorm(x, p[f"{pfx}.ffn.ln2"])
        x = x + ffn(cfg, p, f"{pfx}.ffn", fk, xn)
    return x


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """Token embedding, with the frontend stub's: a vision model's patch
    embeddings projected by `frontend_proj` (in bf16) ahead of the tokens,
    an audio model's frames projected alone. Returns (x [B,S,D], positions
    [B,S] = 0..S-1)."""
    if cfg.frontend == "vision":
        emb = batch["patches"].to(ACT_DTYPE) @ params["frontend_proj"].to(ACT_DTYPE)
        x = torch.cat([emb, embed_lookup(params["embed"], batch["tokens"], ACT_DTYPE)], dim=1)
    elif cfg.frontend == "audio" and "frames" in batch:
        x = batch["frames"].to(ACT_DTYPE) @ params["frontend_proj"].to(ACT_DTYPE)
    else:
        x = embed_lookup(params["embed"], batch["tokens"], ACT_DTYPE)
    B, S = x.shape[:2]
    return x, torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)


def _encoder_layer(cfg, p, x, positions):
    """One encoder layer (`eblk0`): gqa, non-causal, with RoPE, then the
    dense FFN."""
    xn = rmsnorm(x, p["eblk0.mix.ln"])
    y, _ = attn.gqa_attn(cfg, p, "eblk0.mix", xn, positions, mixer="gqa", causal=False)
    x = x + y
    return x + ffn(cfg, p, "eblk0.ffn", "dense", rmsnorm(x, p["eblk0.ffn.ln2"]))


def _run_encoder(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """The encoder over batch["frames"] (the audio frontend's projection),
    `n_enc_layers` layers, then its final norm. Returns enc_out [B,M,D]."""
    x, positions = _embed_inputs(cfg, params, batch)
    for g in range(cfg.n_enc_layers):
        x = _encoder_layer(cfg, _layer(params, "eblk0", g), x, positions)
    return rmsnorm(x, params["enc_final_ln"])


def forward_prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Prefill: full forward + decode-ready cache. batch: {"tokens" [B,S]
    int}, a vision model's {"patches", "tokens"} or an encoder-decoder's
    {"frames", "dec_tokens"}. Returns (last_logits [B,V], cache)."""
    check_supported(cfg)
    enc_out = None
    if cfg.is_encdec:
        enc_out = _run_encoder(cfg, params, batch)
        x, positions = _embed_inputs(cfg, params, {"tokens": batch["dec_tokens"]})
    else:
        x, positions = _embed_inputs(cfg, params, batch)
    enc_len = 0 if enc_out is None else enc_out.shape[1]
    cache = init_cache(cfg, x.shape[0], cache_len, device=x.device, enc_len=enc_len)
    for pfx, g, mixer, fk in _layers(cfg):
        x = _prefill_layer(
            cfg, _layer(params, pfx, g), pfx, mixer, fk, x, positions,
            _layer_cache(cache, pfx, g), cache_len, enc_out,
        )
    x = rmsnorm(x, params["final_ln"])
    return _head(params, x[:, -1]), cache


def _decode_layer(cfg, p, pfx, mixer, fk, x, pos, cache):
    """One decoder layer's decode step, its cache views updated in place
    (an encoder-decoder's: the mixer's under "self", then cross-attention
    over the cached memory K/V)."""
    self_cache = cache["self"] if "self" in cache else cache
    if mixer in _RECURRENT:
        y, state = _RECURRENT_BLOCK[mixer](cfg, p, pfx + ".mix", x, cache=self_cache)
        _write_state(self_cache, state)
    else:
        xn = rmsnorm(x, p[f"{pfx}.mix.ln"])
        if mixer in _MLA:
            y, _ = attn.mla_decode(cfg, p, pfx + ".mix", xn, pos, self_cache)
        else:
            y, _ = attn.gqa_decode(cfg, p, pfx + ".mix", xn, pos, self_cache, mixer=mixer)
    x = x + y
    if "self" in cache:
        xn = rmsnorm(x, p[f"{pfx}.x.ln"])
        x = x + attn.cross_decode(cfg, p, f"{pfx}.x", xn, cache["xk"], cache["xv"])
    if fk != "none":
        xn = rmsnorm(x, p[f"{pfx}.ffn.ln2"])
        x = x + ffn(cfg, p, f"{pfx}.ffn", fk, xn)
    return x


def forward_decode(cfg: ModelConfig, params: dict, token, pos, cache: dict):
    """One decode step. token/pos: [B] int (an encoder-decoder's decoder
    token; a vision model's next text token at position P + T). Returns
    (logits [B,V], cache), the cache updated in place."""
    check_supported(cfg)
    x = embed_lookup(params["embed"], token, ACT_DTYPE)[:, None]  # [B,1,D]
    for pfx, g, mixer, fk in _layers(cfg):
        x = _decode_layer(
            cfg, _layer(params, pfx, g), pfx, mixer, fk, x, pos, _layer_cache(cache, pfx, g)
        )
    x = rmsnorm(x, params["final_ln"])
    return _head(params, x[:, 0]), cache


# ---------------------------------------------------------------------------
# cache specs and zero-init (for real serving)
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, mixer: str, B: int, cache_len: int) -> dict:
    """One layer's cache as nested {name: (shape, dtype)}: bf16 K/V for the
    attention mixers (int8 K/V and float32 scales [B,cap,KV] with
    `kv_cache_dtype="int8"`), MLA's bf16 latent c_kv and k_rope (linear),
    float32 recurrent states and bf16 conv buffers for the recurrent ones
    (the reference's layout)."""
    H, D = cfg.n_heads, cfg.d_model
    f32, bf16 = torch.float32, torch.bfloat16
    if mixer in _ATTN:
        cap = _cache_capacity(cfg, mixer, cache_len)
        shape = (B, cap, cfg.n_kv_heads, cfg.hd)
        if cfg.kv_cache_dtype == "int8":
            i8 = torch.int8
            return {"k": (shape, i8), "v": (shape, i8), "k_scale": (shape[:3], f32),
                    "v_scale": (shape[:3], f32)}
        return {"k": (shape, bf16), "v": (shape, bf16)}
    if mixer in _MLA:
        return {"c_kv": ((B, cache_len, cfg.kv_lora_rank), bf16),
                "k_rope": ((B, cache_len, cfg.rope_head_dim), bf16)}
    if mixer == "mlstm":
        dh = D // H
        return {
            "state": {"C": ((B, H, dh, dh), f32), "n": ((B, H, dh), f32), "m": ((B, H), f32)},
            "conv": ((B, 3, D), bf16),
        }
    if mixer == "slstm":
        leaf = ((B, H, D // H), f32)
        return {"c": leaf, "n": leaf, "m": leaf, "h": leaf}
    if mixer == "rglru":
        E = int(cfg.rnn_scale * D)
        return {"h": ((B, E), f32), "conv": ((B, cfg.rglru_conv_width - 1, E), bf16)}
    raise ValueError(mixer)


def _stacked(spec: dict, G: int) -> dict:
    return {k: _stacked(v, G) if isinstance(v, dict) else ((G,) + v[0], v[1])
            for k, v in spec.items()}


def decode_cache_specs(cfg: ModelConfig, B: int, cache_len: int, enc_len: int = 0) -> dict:
    """{"blk<j>": {"k": (shape, dtype), "v": ...}, "tail<i>": ...}, nested
    for the recurrent mixers; the stacked blocks carry a leading [G] dim.
    An encoder-decoder's layer holds {"self": that, "xk", "xv": bf16
    [B,enc_len,KV,hd]} (enc_len = 0: an empty memory, as the reference's
    router decodes)."""
    check_supported(cfg)
    G = n_groups(cfg)

    def spec(mixer):
        s = _layer_cache_spec(cfg, mixer, B, cache_len)
        if cfg.is_encdec:
            xkv = ((B, enc_len, cfg.n_kv_heads, cfg.hd), torch.bfloat16)
            s = {"self": s, "xk": xkv, "xv": xkv}
        return s

    cache = {}
    for j, (mixer, _) in enumerate(cfg.pattern):
        cache[f"blk{j}"] = _stacked(spec(mixer), G)
    for i, (mixer, _) in enumerate(tail_layers(cfg)):
        cache[f"tail{i}"] = spec(mixer)
    return cache


def _zeros(spec: dict, dev: torch.device) -> dict:
    return {k: _zeros(v, dev) if isinstance(v, dict) else torch.zeros(v[0], dtype=v[1], device=dev)
            for k, v in spec.items()}


def init_cache(cfg: ModelConfig, B: int, cache_len: int, device=None, enc_len: int = 0) -> dict:
    return _zeros(decode_cache_specs(cfg, B, cache_len, enc_len), resolve_device(device))
