"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential recurrence) (port of
`repro.models.xlstm`).

Prefill and training run mLSTM in the stabilized parallel form through the
contract function `mlstm_parallel`: the hand-written CUDA kernel on the
card (`kernels.mlstm.ops.mlstm`, B5, with its hand-written backward when a
gradient is needed), its plain version on CPU tensors. sLSTM
has no kernel in the reference either: its prefill is a Python loop over t
(the reference's `lax.scan`). Decode is the O(1) recurrent update for both.
d_ff = 0 for this family: the blocks carry their own up/down projections.

The blocks return their new recurrent state as the reference does; the
stack copies it into the cache's views (`stack.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.models.layers import rmsnorm, silu


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B,S,D], w: [W,D]. Tap by tap in x's dtype,
    rounding after each product and sum, as the reference does."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i : i + S, :] * w[i][None, None, :]
    return out


def conv_step(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bwd,wd->bd", buf, w): the decode step's conv over the last W
    inputs, summed in float32 and rounded once to buf's dtype."""
    return torch.einsum("bwd,wd->bd", buf.float(), w.float()).to(buf.dtype)


def conv_state(x: torch.Tensor, W: int) -> torch.Tensor:
    """The last W - 1 inputs [B,W-1,D] a decode step's conv needs. A prompt
    shorter than W - 1 is padded with the zeros the causal conv saw (the
    reference keeps the shorter slice, which its decode cannot take)."""
    return F.pad(x, (0, 0, max(W - 1 - x.shape[1], 0), 0))[:, -(W - 1) :]


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def mlstm_parallel(q, k, v, logi, logf):
    """Stabilized parallel mLSTM (xLSTM paper eq. 19-27). q/k/v: [B,H,S,dh];
    logi/logf: [B,H,S] (log input gate, log sigmoid forget). Returns h:
    [B,H,S,dh]. The reference splits the queries into chunks of 512 (and
    keeps only the first 512 rows when S is above 512 and not a multiple of
    it, ROADMAP C4); the kernel takes every S."""
    return mlstm_ops.mlstm(q, k, v, logi, logf)


def mlstm_step(state, q, k, v, logi, logf):
    """O(1) decode update. state: dict(C [B,H,dk,dv], n [B,H,dk], m [B,H]).
    q/k/v: [B,H,dh]; logi/logf: [B,H]."""
    C, n, m = state["C"], state["n"], state["m"]
    dh = q.shape[-1]
    m_new = torch.maximum(logf + m, logi)
    fa = torch.exp(logf + m - m_new)[..., None]
    ia = torch.exp(logi - m_new)[..., None]
    n_new = fa * n + ia * k
    C_new = fa[..., None] * C + (ia * k)[..., None] * v[..., None, :]
    qn = q * (dh**-0.5)
    num = torch.einsum("bhk,bhkv->bhv", qn, C_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qn, n_new).abs(), torch.exp(-m_new))
    h = num / den[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h


def mlstm_final_state(k, v, logi, logf):
    """Recurrent state (C, n, m) after consuming the whole sequence — seeds
    the decode cache from a prefill. k/v: [B,H,S,dh]; gates [B,H,S]."""
    Fc = torch.cumsum(logf, dim=-1)
    w_log = Fc[..., -1:] - Fc + logi  # [B,H,S]
    m = w_log.amax(dim=-1)  # [B,H]
    w = torch.exp(w_log - m[..., None])
    C = torch.einsum("bhs,bhsk,bhsv->bhkv", w, k, v)
    n = torch.einsum("bhs,bhsk->bhk", w, k)
    return {"C": C, "n": n, "m": m}


def mlstm_block(cfg, p, prefix, x, *, cache=None, return_state: bool = False):
    """Full mLSTM residual block. x: [B,S,D] (S = 1 with cache). Returns
    (out, new_cache): {"state": {"C", "n", "m"}, "conv"} or None."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    dt = x.dtype
    w_conv = p[f"{prefix}.conv"].to(dt)
    xn = rmsnorm(x, p[f"{prefix}.ln"])
    u = xn @ p[f"{prefix}.wu"].to(dt)  # [B,S,2D]
    a, b = torch.chunk(u, 2, dim=-1)
    if cache is None:
        c = causal_conv(a, w_conv)
    else:
        buf = torch.cat([cache["conv"], a], dim=1)  # [B,W,D]
        c = conv_step(buf, w_conv)[:, None]
        conv_cache = buf[:, 1:]
    c = silu(c)
    q = c @ p[f"{prefix}.wq"].to(dt)
    k = c @ p[f"{prefix}.wk"].to(dt)
    v = a @ p[f"{prefix}.wv"].to(dt)
    # the gate sums stay float32: XLA compiles the reference's
    # `(x @ wi + bi).astype(f32)` without rounding the bf16 sum (excess
    # precision), and the exponential gates would amplify that rounding
    logi = (xn @ p[f"{prefix}.wi"].to(dt)).float() + p[f"{prefix}.bi"].to(dt).float()
    gf = (xn @ p[f"{prefix}.wf"].to(dt)).float() + p[f"{prefix}.bf"].to(dt).float()
    logf = F.logsigmoid(gf)

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if cache is None:
        li, lf = logi.transpose(1, 2), logf.transpose(1, 2)
        # the heads in their own dtype: the kernel computes in float32 and
        # writes h in v's dtype, the rounding `.to(dt)` below applied to a
        # float32 h (bf16 heads take the tensor-core kernel)
        h = mlstm_parallel(qh, kh, vh, li, lf)
        new_cache = None
        if return_state:
            new_cache = {
                "state": mlstm_final_state(kh.float(), vh.float(), li, lf),
                "conv": conv_state(a, w_conv.shape[0]),
            }
    else:
        st, h1 = mlstm_step(cache["state"], qh[:, :, 0].float(), kh[:, :, 0].float(),
                            vh[:, :, 0].float(), logi[:, 0], logf[:, 0])
        h = h1[:, :, None, :]
        new_cache = {"state": st, "conv": conv_cache}
    hs = h.transpose(1, 2).reshape(B, S, D).to(dt)
    hs = rmsnorm(hs, p[f"{prefix}.mn"])  # per-head norm approximated group-wise
    out = hs * silu(b)
    return out @ p[f"{prefix}.wd"].to(dt), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_block(cfg, p, prefix, x, *, cache=None, return_state: bool = False):
    """sLSTM residual block with per-head block-diagonal recurrence. Prefill:
    a Python loop over t. Decode: a single step. Returns (out, new_cache):
    {"c", "n", "m", "h"} or None."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    dt = x.dtype
    xn = rmsnorm(x, p[f"{prefix}.ln"])
    # input contributions for the 4 gates: [B,S,4D]
    zx = xn @ p[f"{prefix}.wzifo"].to(dt) + p[f"{prefix}.bzifo"].to(dt)
    r = p[f"{prefix}.r"].float()  # [4,H,dh,dh] recurrent per head

    def step(carry, zt):
        c, n, m, h = carry  # [B,H,dh] each, float32
        rec = torch.einsum("bhk,ghkl->bghl", h, r)  # [B,4,H,dh]
        zt = zt.float().reshape(B, 4, H, dh) + rec
        z, i, f, o = zt.unbind(1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        logf = F.logsigmoid(f)
        m_new = torch.maximum(logf + m, i)
        ia = torch.exp(i - m_new)
        fa = torch.exp(logf + m - m_new)
        c_new = fa * c + ia * z
        n_new = torch.maximum(fa * n + ia, torch.exp(-m_new))
        h_new = o * (c_new / n_new)
        return c_new, n_new, m_new, h_new

    if cache is None:
        z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        carry = (z0, torch.ones_like(z0), z0, z0)
        hs = []
        for t in range(S):
            carry = step(carry, zx[:, t])
            hs.append(carry[3])
        hs = torch.stack(hs, dim=1).reshape(B, S, D).to(dt)
        new_cache = dict(zip("cnmh", carry)) if return_state else None
    else:
        carry = step((cache["c"], cache["n"], cache["m"], cache["h"]), zx[:, 0])
        hs = carry[3].reshape(B, 1, D).to(dt)
        new_cache = dict(zip("cnmh", carry))
    hs = rmsnorm(hs, p[f"{prefix}.mn"])
    return hs @ p[f"{prefix}.wd"].to(dt), new_cache
