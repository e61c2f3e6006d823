"""Plain PyTorch version of the RG-LRU kernel: a straight translation of
`repro.kernels.rglru.ref.rglru_ref` (a sequential loop over t), and of the
reference op's input formation (`repro.kernels.rglru.ops.rglru`). The CPU
path of the wrappers, and what `chip_smoke.py` holds the CUDA kernel
against."""

from __future__ import annotations

import torch


def gated_input(log_a, gated_x):
    """b = sqrt(clip(1 - a², 0, 1)) · gated_x in float32, a = exp(log_a),
    cast to gated_x's dtype. log_a/gated_x: [B,S,E]."""
    a = torch.exp(log_a.float())
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * gated_x.float()
    return b.to(gated_x.dtype)


def rglru_ref(log_a, b, h0=None):
    """log_a/b: [B,S,E] -> h: [B,S,E] in b's dtype (float32 carry)."""
    B, S, E = log_a.shape
    a = torch.exp(log_a.float())
    bf = b.float()
    h = torch.zeros((B, E), dtype=torch.float32, device=b.device) if h0 is None else h0.float()
    hs = torch.empty((B, S, E), dtype=torch.float32, device=b.device)
    for t in range(S):
        h = a[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(b.dtype)


def rglru_bwd_ref(log_a, x, h, dh, h0=None, fused=False):
    """The gradient of the scan `rglru_ref(log_a, b, h0)` (`fused=False`: x
    is b) or of the op `rglru` (`fused=True`: x is gx and b = sqrt(clip(1 -
    a², 0, 1)) · gx), by explicit formulas in float32 (no autograd).
    log_a/x/h/dh: [B,S,E], h the forward's output and dh its gradient; h0
    the forward's carry [B,E] or None.

    The reverse scan g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0) gives
    db_t = g_t and dlog_a_t = g_t · a_t · h_{t-1} (h_{-1} = h0, or 0), and
    dh0 = a_0 · g_0. Fused, b's formation adds dgx = g · sqrt(1 - a²) and,
    where 0 < 1 - a² < 1 (inside the clip), -g · gx · a² / sqrt(1 - a²) to
    dlog_a. Returns (dlog_a, db or dgx, dh0 or None): dlog_a and dh0
    float32, db / dgx in x's dtype."""
    B, S, E = log_a.shape
    a = torch.exp(log_a.float())
    dhf = dh.float()
    g = torch.empty((B, S, E), dtype=torch.float32, device=dh.device)
    acc = torch.zeros((B, E), dtype=torch.float32, device=dh.device)
    for t in range(S - 1, -1, -1):
        if t + 1 < S:
            acc = a[:, t + 1] * acc
        acc = dhf[:, t] + acc
        g[:, t] = acc
    first = torch.zeros((B, 1, E), dtype=torch.float32, device=h.device) if h0 is None \
        else h0.float()[:, None]
    h_prev = torch.cat([first, h.float()[:, :-1]], dim=1)
    dlog_a = g * a * h_prev
    dh0 = None if h0 is None else a[:, 0] * g[:, 0]
    if not fused:
        return dlog_a, g.to(x.dtype), dh0
    y = 1.0 - a * a
    s = torch.sqrt(torch.clamp(y, 0.0, 1.0))
    inside = (y > 0.0) & (y < 1.0)
    dlog_a = dlog_a + torch.where(inside, -g * x.float() * (a * a) / torch.where(inside, s, 1.0),
                                  0.0)
    return dlog_a, (g * s).to(x.dtype), dh0
