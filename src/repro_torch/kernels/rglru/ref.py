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
