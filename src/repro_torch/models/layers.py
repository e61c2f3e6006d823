"""Elementary layers: norms, RoPE, activations, dense and MoE FFN, embedding
(port of `repro.models.layers`).

Pure functions over (params-dict, activations); reductions in float32 and
weights cast to the activations' dtype before each product, as the
reference's `astype(x.dtype)` does. The attention paths live in
`attention.py` and the CUDA kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(cfg, x, scale, bias=None):
    """`cfg.norm`'s normalisation. The forward passes call `rmsnorm`
    directly, as the reference's do: neither reads `cfg.norm`, so
    seamless-m4t's `norm="layernorm"` runs RMSNorm in both (ROADMAP §C, C7)."""
    if cfg.norm == "layernorm":
        return layernorm(x, scale, bias if bias is not None else torch.zeros_like(scale))
    return rmsnorm(x, scale)


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


def moe_capacity(cfg, B: int, S: int) -> int:
    """Slots a batch row gives each expert (GShard capacity, per row)."""
    return max(int(cfg.capacity_factor * cfg.top_k * B * S / (cfg.n_experts * max(B, 1))), 1)


class Routing(NamedTuple):
    """`moe_route`'s result. topi, topv, pos, kept [B,S,K]: the experts,
    their renormalised float32 gates, each assignment's slot in its
    expert's buffer of the row (the count of earlier assignments to that
    expert, token-major then k) and whether that slot is below the
    capacity; gates [B,S,E]: the float32 softmax over every expert."""

    topi: torch.Tensor
    topv: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    gates: torch.Tensor


def moe_route(cfg, p, prefix: str, x: torch.Tensor) -> Routing:
    """Top-k routing with capacity, as the reference's `moe_ffn` routes.
    Logits are a product in x's dtype, the softmax float32. Ties go to the
    lower expert index, as `jax.lax.top_k` breaks them: a stable descending
    sort (`torch.topk` promises no order, and bf16 logits tie often)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = x @ p[f"{prefix}.router"].to(x.dtype)
    gates = torch.softmax(logits.float(), dim=-1)  # [B,S,E]
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(topi.reshape(B, S * K), E)  # [B,S*K,E]
    before = onehot.cumsum(1) - onehot
    pos = before.gather(-1, topi.reshape(B, S * K, 1)).reshape(B, S, K)
    return Routing(topi, topv, pos, pos < moe_capacity(cfg, B, S), gates)


def moe_ffn(cfg, p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Top-k routed MoE with GShard-style capacity dispatch (port of the
    reference's `moe_ffn`): the same function, not the same einsums.

    Each (expert, row, slot) holds at most one token, so the dispatch is a
    scatter of token rows into [E, B*C, D] (exactly the values of the
    one-hot dispatch einsum; an assignment past the capacity goes to a
    trash row and contributes zero) and the combine a gather of each
    token's K expert outputs, weighted by its gates rounded to x's dtype
    (the reference's `combine.astype(x.dtype)`), summed in float32 and
    rounded once. The one-hot form's [B,S,K,E,C] position tensor and its
    products over zeros (~1.7 GB and ~1.7e12 flops a layer at mixtral's
    4 x 4608 prefill) are never formed. The expert products are batched
    over e, in x's dtype, over every slot as the reference's are."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, B, S)
    topi, topv, pos, kept, _ = moe_route(cfg, p, prefix, x)
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot = ((topi * B + rows) * C + pos).reshape(-1)  # row of [E*B*C, D]
    kept = kept.reshape(-1)
    trash = E * B * C
    xe = x.new_zeros(trash + 1, D)
    xe[torch.where(kept, slot, trash)] = x[:, :, None].expand(B, S, K, D).reshape(-1, D)
    xe = xe[:trash].view(E, B * C, D)
    g = torch.bmm(xe, p[f"{prefix}.we_g"].to(x.dtype))
    u = torch.bmm(xe, p[f"{prefix}.we_u"].to(x.dtype))
    ye = torch.bmm(act_fn(cfg.act)(g) * u, p[f"{prefix}.we_d"].to(x.dtype)).view(-1, D)
    w = topv.to(x.dtype).float().reshape(-1, 1)
    got = ye[torch.where(kept, slot, 0)].float() * w
    got = torch.where(kept[:, None], got, 0.0)
    return got.view(B, S, K, D).sum(2).to(x.dtype)


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



def gather_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels]: the reference's sum(one_hot(labels) * logits)
    (one entry times 1.0 plus zeros: the same values) as a gather, without
    the [..., vocab] one-hot."""
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
