"""Elementary layers: norms, RoPE, activations, dense FFN, embedding (port of
`repro.models.layers`).

Pure functions over (params-dict, activations); reductions in float32 and
weights cast to the activations' dtype before each product, as the
reference's `astype(x.dtype)` does. The attention paths live in
`attention.py` and the CUDA kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.unported import not_ported


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def act_fn(name: str):
    """The dense FFN's activations: PyTorch's fused forms, one kernel each,
    rounding a bf16 result once (jax.nn rounds after each op; the FFN does
    not amplify that difference)."""
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# The recurrent blocks' activations follow jax.nn's op order in the input's
# dtype, so a bf16 input rounds after each op where the reference's does
# (bitwise equal to it; the fused forms differ in ~40% of bf16 outputs, and
# the blocks' exponential gates amplify such differences over depth).


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (tanh) form, its constants in x's dtype."""
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., None].float() * freqs  # [B,S,D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def dense_ffn(cfg, p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Gated FFN (SwiGLU/GeGLU): out = W2( act(W_g x) * (W_u x) )."""
    g = x @ p[f"{prefix}.wg"].to(x.dtype)
    u = x @ p[f"{prefix}.wu"].to(x.dtype)
    h = act_fn(cfg.act)(g) * u
    return h @ p[f"{prefix}.wd"].to(x.dtype)


def moe_ffn(cfg, p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    raise not_ported("the MoE FFN (moe_ffn)", "A9")


def ffn(cfg, p, prefix: str, kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "moe":
        return moe_ffn(cfg, p, prefix, x)
    if kind == "none":
        return torch.zeros_like(x)
    return dense_ffn(cfg, p, prefix, x)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of `table` cast to `dtype`. The reference multiplies a one-hot
    by the table (an SPMD-friendly lookup); each output there is 1.0 x one
    entry plus zeros, so the gathered rows are exactly equal, without the
    [..., vocab] one-hot (4.2 GB in bf16 at 8 x 2048 tokens of a 128k vocab)."""
    return table[ids.long()].to(dtype)

