"""Unified model configuration covering all ten assigned architectures.

The port's own copy of `repro.models.config` (the port imports nothing of
`repro`); `tests/test_torch_models.py` holds every field the reference has
equal. One field is the port's own: `irope`, which the reference decides
from the model's name (`src/repro/models/attention.py`: llama4 takes no
RoPE on its global `gqa` layers).

A model is a stack of `n_layers` blocks. Blocks repeat with period
`len(pattern)`; each pattern entry names a (mixer, ffn) pair:

  mixer: "gqa"   — grouped-query attention (optional QKV bias, RoPE)
         "swa"   — sliding-window GQA
         "cla"   — chunked local attention (Llama-4 iRoPE style)
         "mla"   — multi-head latent attention (MiniCPM3 / DeepSeek-V2)
         "mlstm" — xLSTM matrix-memory block
         "slstm" — xLSTM scalar-memory block
         "rglru" — RG-LRU temporal block (Griffin / RecurrentGemma)
  ffn:   "dense" | "moe" | "none" (xLSTM blocks integrate their own proj)

Encoder-decoder models (seamless-m4t) set `n_enc_layers` > 0; the decoder
adds cross-attention to every block. Modality frontends ("audio"/"vision")
are STUBS per the assignment: input_specs() feeds precomputed frame/patch
embeddings of `frontend_dim`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    pattern: tuple = (("gqa", "dense"),)
    tail: tuple = ()  # extra layers after the scanned groups (n_layers % period)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    irope: bool = False  # iRoPE: no RoPE on the global ("gqa") layers
    window: int = 4096  # swa/cla window or chunk
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # MLA dims (MiniCPM3-4B defaults)
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    rope_head_dim: int = 32
    nope_head_dim: int = 64
    v_head_dim: int = 0  # 0 => nope + rope
    # recurrent dims
    rglru_conv_width: int = 4
    rnn_scale: float = 1.0  # recurrent block width multiplier
    # encoder-decoder / frontends
    n_enc_layers: int = 0
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0
    # serving
    max_seq: int = 32768
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8" (quantized cache, §Perf)
    # attention softcap (recurrentgemma uses logit softcapping)
    attn_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def v_hd(self) -> int:
        if self.v_head_dim:
            return self.v_head_dim
        if self.has_mla:
            return self.nope_head_dim
        return self.hd

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        rem = self.n_layers - len(self.tail)
        if rem % self.period:
            raise ValueError(f"{self.name}: {self.n_layers} layers minus the tail "
                             f"is not a multiple of the period {self.period}")
        return rem // self.period

    @property
    def has_mla(self) -> bool:
        return any(m == "mla" for m, _ in self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Every mixer is windowed/chunked or recurrent (bounded state)."""
        return all(
            m in ("swa", "cla", "mlstm", "slstm", "rglru")
            for m, _ in tuple(self.pattern) + tuple(self.tail)
        )

    @property
    def long_context_capable(self) -> bool:
        """long_500k runs unless the arch is *pure* full attention (per the
        assignment: run for SSM/hybrid/linear-attn, skip pure-quadratic)."""
        return any(
            m in ("swa", "cla", "mlstm", "slstm", "rglru")
            for m, _ in tuple(self.pattern) + tuple(self.tail)
        )

    def params_dense(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6*N*D."""
        from repro_torch.models.stack import build_schema
        from repro_torch.models.schema import param_count

        return param_count(build_schema(self))

    def params_active(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        n = self.params_dense()
        if self.n_experts > 0:
            moe_layers = sum(1 for _, f in self.pattern if f == "moe") * self.n_groups
            per_expert = 3 * self.d_model * self.d_ff
            n -= moe_layers * per_expert * (self.n_experts - self.top_k)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)
