"""Architecture registry: `get(name)` / `reduced(name)` for every assigned
config. The port's own copy of `repro.configs.registry`'s data;
`tests/test_torch_models.py` holds every field of every config, and of its
`reduced()`, equal to the reference."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    return _REGISTRY[name]


def names() -> list:
    return sorted(_REGISTRY.keys())


def reduced(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: few layers, narrow width,
    few experts, small vocab — identical block structure."""
    cfg = get(name)
    period = len(cfg.pattern)
    tail = cfg.tail
    n_layers = period + len(tail)  # one scanned group + the tail
    d_model = 128
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4
    changes = dict(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 64),
        max_seq=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        capacity_factor=8.0,  # no-drop in tests => decode == train exactly
        q_lora_rank=64,
        kv_lora_rank=32,
        rope_head_dim=16,
        nope_head_dim=32,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        frontend_dim=64 if cfg.frontend != "none" else 0,
    )
    return dataclasses.replace(cfg, **changes)


# --- dense -------------------------------------------------------------------

QWEN2_72B = register(
    ModelConfig(
        name="qwen2-72b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,  # Qwen2 uses QKV bias [arXiv:2407.10671]
        rope_theta=1_000_000.0,
        pattern=(("gqa", "dense"),),
    )
)

MINICPM3_4B = register(
    ModelConfig(
        name="minicpm3-4b",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        pattern=(("mla", "dense"),),  # MLA [hf:openbmb/MiniCPM3-4B]
        q_lora_rank=768,
        kv_lora_rank=256,
        rope_head_dim=32,
        nope_head_dim=64,
        tie_embeddings=True,
    )
)

H2O_DANUBE3_4B = register(
    ModelConfig(
        name="h2o-danube-3-4b",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab=32000,
        head_dim=120,
        pattern=(("swa", "dense"),),  # llama+mistral mix, sliding window
        window=4096,
        rope_theta=10_000.0,
    )
)

LLAMA32_3B = register(
    ModelConfig(
        name="llama3.2-3b",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        rope_theta=500_000.0,
        pattern=(("gqa", "dense"),),
        tie_embeddings=True,
    )
)

# --- ssm ----------------------------------------------------------------------

XLSTM_350M = register(
    ModelConfig(
        name="xlstm-350m",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,  # blocks carry their own projections
        vocab=50304,
        # xLSTM[7:1]: seven mLSTM blocks per sLSTM block [arXiv:2405.04517]
        pattern=(
            ("mlstm", "none"),
            ("mlstm", "none"),
            ("mlstm", "none"),
            ("slstm", "none"),
            ("mlstm", "none"),
            ("mlstm", "none"),
            ("mlstm", "none"),
            ("mlstm", "none"),
        ),
    )
)

# --- audio enc-dec -------------------------------------------------------------

SEAMLESS_M4T_LARGE_V2 = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        n_layers=24,
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256206,
        norm="layernorm",
        act="gelu",
        pattern=(("gqa", "dense"),),
        frontend="audio",
        frontend_dim=160,  # fbank-frame stub embeddings [arXiv:2308.11596]
    )
)

# --- moe -----------------------------------------------------------------------

MIXTRAL_8X7B = register(
    ModelConfig(
        name="mixtral-8x7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        pattern=(("swa", "moe"),),  # 8 experts top-2 + SWA [arXiv:2401.04088]
        window=4096,
        n_experts=8,
        top_k=2,
        rope_theta=1_000_000.0,
    )
)

LLAMA4_SCOUT = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        # iRoPE-style: 3 chunked-local layers + 1 global NoPE layer; MoE 16e top-1
        pattern=(
            ("cla", "moe"),
            ("cla", "moe"),
            ("cla", "moe"),
            ("gqa", "moe"),
        ),
        window=8192,
        irope=True,
        n_experts=16,
        top_k=1,
        rope_theta=500_000.0,
    )
)

# --- vlm -----------------------------------------------------------------------

INTERNVL2_26B = register(
    ModelConfig(
        name="internvl2-26b",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92553,
        pattern=(("gqa", "dense"),),
        frontend="vision",
        frontend_dim=3200,  # InternViT-6B patch-embedding stub [arXiv:2404.16821]
        rope_theta=1_000_000.0,
    )
)

# --- hybrid ---------------------------------------------------------------------

RECURRENTGEMMA_9B = register(
    ModelConfig(
        name="recurrentgemma-9b",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,  # MQA
        d_ff=12288,
        vocab=256000,
        # Griffin 1:2 — (rglru, rglru, local attn) x 12, tail (rglru, rglru)
        pattern=(("rglru", "dense"), ("rglru", "dense"), ("swa", "dense")),
        tail=(("rglru", "dense"), ("rglru", "dense")),
        window=2048,
        act="gelu",
        attn_softcap=50.0,
        rnn_scale=1.0,
        tie_embeddings=True,
    )
)

ALL_ARCHS = names()
