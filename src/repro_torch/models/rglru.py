"""RG-LRU recurrent block (Griffin, arXiv:2402.19427 / RecurrentGemma)
(port of `repro.models.rglru`).

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill, decode and training run the RG-LRU op through
`kernels.rglru.ops.rglru`: on the card one launch of the hand-written CUDA
kernel (B4) forms b and scans (and, for a gradient, one launch of its
hand-written reverse scan), on CPU tensors the plain version. Decode is the op at S = 1 from the
cached carry h0, the reference's O(1) update. The block is the Griffin
recurrent block:
y = W_out( GeLU(W_gate xn) * RGLRU(conv4(W_x xn)) ).

The gate weights (wa, wi, ba, bi, lam) stay float32: the reference's
einsum of bf16 activations with float32 weights promotes to float32, so the
gate products are float32 products here too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.layers import gelu, rmsnorm, sigmoid
from repro_torch.models.xlstm import causal_conv, conv_state, conv_step

_C = 8.0


def _gates(p, prefix, xr):
    """(log_a, i) [B,S,E] float32 from the conv output xr (bf16)."""
    xf = xr.float()
    r = sigmoid(xf @ p[f"{prefix}.wa"].float() + p[f"{prefix}.ba"].float())
    i = sigmoid(xf @ p[f"{prefix}.wi"].float() + p[f"{prefix}.bi"].float())
    lam = F.softplus(p[f"{prefix}.lam"].float())  # [d_rnn]
    return -_C * lam * r, i


def rglru_scan(log_a, gx):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t²) gx_t. log_a/gx: [B,S,E] float32."""
    return rglru_ops.rglru(log_a, gx)


def rglru_block(cfg, p, prefix, x, *, cache=None, return_state: bool = False):
    """Griffin recurrent residual block. Returns (out, new_cache):
    {"h", "conv"} or None."""
    dt = x.dtype
    w_conv = p[f"{prefix}.conv"].to(dt)
    xn = rmsnorm(x, p[f"{prefix}.ln"])
    gate = gelu(xn @ p[f"{prefix}.wgate"].to(dt))
    xr = xn @ p[f"{prefix}.wx"].to(dt)
    if cache is None:
        xc = causal_conv(xr, w_conv)
        log_a, i = _gates(p, prefix, xc)
        h = rglru_scan(log_a, i * xc.float())
        new_cache = None
        if return_state:
            new_cache = {"h": h[:, -1], "conv": conv_state(xr, w_conv.shape[0])}
    else:
        buf = torch.cat([cache["conv"], xr], dim=1)
        xc = conv_step(buf, w_conv)[:, None]
        log_a, i = _gates(p, prefix, xc)
        h = rglru_ops.rglru(log_a, i * xc.float(), h0=cache["h"])
        new_cache = {"h": h[:, 0], "conv": buf[:, 1:]}
    y = h.to(dt) * gate
    return y @ p[f"{prefix}.wout"].to(dt), new_cache
