"""Analytic FLOPs / HBM-traffic model per (architecture x shape cell)
(port of `repro.models.flops`).

The exact dense-algebra FLOPs of the stack (every product is known), the
compute term of a step's bound: `chip_smoke.py` divides `cell_flops` by the
card's bf16 tensor rate and `cell_hbm_bytes` by its HBM rate. The
arithmetic is the reference's, in the reference's order, so the numbers
are equal to its float for float (`tests/test_torch_flops.py`).

Conventions: 1 MAC = 2 FLOPs. Backward = 2x forward; per-layer-group remat
adds ~1x forward for the scanned stack. MODEL_FLOPS = 6*N*D_tokens (dense) or
6*N_active*D_tokens (MoE), reported separately to expose remat/dispatch waste.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShapeCell


def _attn_layer_flops(cfg: ModelConfig, S: int, mixer: str, kv_len: int | None = None):
    """Forward FLOPs for one attention layer over S query tokens."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    proj = 2 * S * D * (H * hd) + 2 * 2 * S * D * (KV * hd) + 2 * S * (H * hd) * D
    if cfg.qkv_bias:
        proj += S * (H + 2 * KV) * hd
    if kv_len is None:  # self attention over S
        if mixer == "swa" and cfg.window < S:
            eff = cfg.window  # banded
        elif mixer == "cla" and cfg.window < S:
            eff = cfg.window // 2 + 1  # same-chunk average
        else:
            eff = (S + 1) / 2  # causal average
        sc = 2 * 2 * S * eff * H * hd  # QK^T + PV
    else:
        eff = min(kv_len, cfg.window) if mixer in ("swa", "cla") and cfg.window < kv_len else kv_len
        sc = 2 * 2 * S * eff * H * hd
    return proj + sc


def _mla_layer_flops(cfg: ModelConfig, S: int, kv_len: int | None = None):
    D, H = cfg.d_model, cfg.n_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    proj = (
        2 * S * D * r_q
        + 2 * S * r_q * H * qk
        + 2 * S * D * (r_kv + cfg.rope_head_dim)
        + 2 * S * r_kv * H * (cfg.nope_head_dim + cfg.v_hd)
        + 2 * S * H * cfg.v_hd * D
    )
    L = (S + 1) / 2 if kv_len is None else kv_len
    if kv_len is not None:
        # absorbed decode: scores against the latent cache
        sc = 2 * S * H * cfg.nope_head_dim * r_kv + 2 * S * H * L * (
            r_kv + cfg.rope_head_dim
        ) + 2 * S * H * L * r_kv + 2 * S * H * r_kv * cfg.v_hd
    else:
        sc = 2 * S * L * H * qk + 2 * S * L * H * cfg.v_hd  # QK^T + PV
    return proj + sc


def _mlstm_layer_flops(cfg: ModelConfig, S: int, decode: bool = False):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    proj = 2 * S * D * 2 * D + 3 * 2 * S * D * D + 2 * S * D * D + 2 * S * D * 2 * H
    if decode:
        cell = S * H * (3 * dh * dh + 4 * dh)  # C update + read per token
    else:
        cell = 2 * 2 * S * ((S + 1) / 2) * H * dh  # parallel form ~ attention
    return proj + cell + 4 * 4 * S * D  # conv4


def _slstm_layer_flops(cfg: ModelConfig, S: int):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    return 2 * S * D * 4 * D + S * 4 * H * 2 * dh * dh + 2 * S * D * D


def _rglru_layer_flops(cfg: ModelConfig, S: int):
    D = cfg.d_model
    E = int(cfg.rnn_scale * D)
    proj = 2 * S * D * E * 2 + 2 * S * E * D  # wgate, wx, wout
    gates = 2 * 2 * S * E * E  # wa, wi
    scan = 8 * S * E  # elementwise recurrence
    conv = 2 * cfg.rglru_conv_width * S * E
    return proj + gates + scan + conv


def _ffn_flops(cfg: ModelConfig, S: int, kind: str):
    D, F = cfg.d_model, cfg.d_ff
    if kind == "none":
        return 0
    if kind == "moe":
        E, K = cfg.n_experts, cfg.top_k
        cap_tokens = cfg.capacity_factor * K * S  # tokens processed by experts
        expert = 3 * 2 * cap_tokens * D * F
        router = 2 * S * D * E
        # dispatch/combine one-hot einsums: [S,E,C]x[S,D] twice
        cap = cfg.capacity_factor * K * S / E
        dispatch = 2 * 2 * S * E * cap * D
        return expert + router + dispatch
    return 3 * 2 * S * D * F


def _layer_flops(cfg: ModelConfig, mixer: str, fk: str, S: int, kv_len=None, decode=False):
    if mixer in ("gqa", "swa", "cla"):
        f = _attn_layer_flops(cfg, S, mixer, kv_len)
    elif mixer == "mla":
        f = _mla_layer_flops(cfg, S, kv_len)
    elif mixer == "mlstm":
        f = _mlstm_layer_flops(cfg, S, decode)
    elif mixer == "slstm":
        f = _slstm_layer_flops(cfg, S)
    elif mixer == "rglru":
        f = _rglru_layer_flops(cfg, S)
    else:
        raise ValueError(mixer)
    return f + _ffn_flops(cfg, S, fk)


def _all_layers(cfg: ModelConfig):
    from repro_torch.models.stack import n_groups, tail_layers

    layers = list(cfg.pattern) * n_groups(cfg) + list(tail_layers(cfg))
    return layers


def forward_flops(cfg: ModelConfig, batch: int, S: int, kv_len=None, decode=False) -> float:
    """Forward FLOPs for `batch` sequences of S tokens (per-token decode when
    decode=True, attending to kv_len cache)."""
    total = 0.0
    for mixer, fk in _all_layers(cfg):
        total += _layer_flops(cfg, mixer, fk, S, kv_len=kv_len, decode=decode)
    if cfg.is_encdec:
        # encoder layers + cross attention in each decoder layer
        enc_S = S  # frames
        for _ in range(cfg.n_enc_layers):
            total += _layer_flops(cfg, "gqa", "dense", enc_S)
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dec_S = max(S // 4, 128) if not decode else S
        xa = 2 * dec_S * D * H * hd * 2 + 2 * 2 * dec_S * enc_S * H * hd
        total += cfg.n_layers * xa
    # embedding one-hot dot + logits + CE
    V, D = cfg.vocab, cfg.d_model
    total += 2 * S * V * D  # one-hot lookup
    total += 2 * S * D * V  # logits
    return total * batch


_REMAT_FACTOR = {"full": 4.0, "dots": 3.1, "none": 3.0}


def cell_flops(cfg: ModelConfig, cell: ShapeCell, remat: str = "full") -> dict:
    """Returns dict(total=HLO-equivalent flops, model=6*N*D).

    remat: "full"  — checkpoint per layer group: +1x forward recompute.
           "dots"  — save matmul outputs; recompute only elementwise (~+0.1x).
           "none"  — no recompute (fwd + 2x bwd).
    """
    B, S = cell.global_batch, cell.seq_len
    act = cfg.params_active()
    if cell.kind == "train":
        dec_S = max(S // 4, 128) if cfg.is_encdec else S
        fwd = forward_flops(cfg, B, S)
        total = _REMAT_FACTOR[remat] * fwd
        model = 6.0 * act * B * (dec_S if cfg.is_encdec else S)
        return {"total": total, "model": model}
    if cell.kind == "prefill":
        fwd = forward_flops(cfg, B, S)
        return {"total": fwd, "model": 2.0 * act * B * S}
    # decode: one token, cache of S
    fwd = forward_flops(cfg, B, 1, kv_len=S, decode=True)
    return {"total": fwd, "model": 2.0 * act * B}


# ---------------------------------------------------------------------------
# HBM traffic model
# ---------------------------------------------------------------------------


def cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Total decode-cache bytes for batch B, context S."""
    from repro_torch.models.stack import _cache_capacity

    total = 0.0
    for mixer, _ in _all_layers(cfg):
        if mixer in ("gqa", "swa", "cla"):
            cap = _cache_capacity(cfg, mixer, S)
            if cfg.kv_cache_dtype == "int8":
                total += 2 * B * cap * cfg.n_kv_heads * (cfg.hd * 1 + 4)  # int8+scale
            else:
                total += 2 * B * cap * cfg.n_kv_heads * cfg.hd * 2  # k+v bf16
        elif mixer == "mla":
            total += B * S * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
        elif mixer == "mlstm":
            dh = cfg.d_model // cfg.n_heads
            total += B * cfg.n_heads * (dh * dh + dh + 1) * 4 + B * 3 * cfg.d_model * 2
        elif mixer == "slstm":
            total += 4 * B * cfg.d_model * 4
        elif mixer == "rglru":
            E = int(cfg.rnn_scale * cfg.d_model)
            total += B * E * 4 + B * (cfg.rglru_conv_width - 1) * E * 2
    if cfg.is_encdec:
        total += cfg.n_layers * 2 * B * S * cfg.n_kv_heads * cfg.hd * 2
    return total


def cell_hbm_bytes(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Whole-step HBM traffic (all chips combined).

    train : params bf16 read 3x (fwd/bwd/remat) * accum-independent +
            grads f32 rw + optimizer m/v read+write + params f32 rw +
            checkpointed activations write+read.
    decode: params read once + cache read + cache write (delta) + activations.
    prefill: params read + activations + cache write.
    """
    P = cfg.params_dense()
    B, S = cell.global_batch, cell.seq_len
    D = cfg.d_model
    L = cfg.n_layers
    if cell.kind == "train":
        wb = 3 * P * 2  # bf16 weight reads (fwd, bwd, remat recompute)
        opt = P * 4 * 6  # m,v read+write + params f32 read+write
        grads = P * 4 * 2
        acts = 2 * B * S * D * 2 * L  # checkpoint saves + reads (bf16)
        return wb + opt + grads + acts
    if cell.kind == "prefill":
        return P * 2 + 2 * B * S * D * 2 * L + cache_bytes(cfg, B, S)
    # decode
    return P * 2 + cache_bytes(cfg, B, S) + 2 * B * D * 2 * L
