"""The RG-LRU wrappers: the gate transform, checks, allocation, launch,
count.

`rglru(log_a, gated_x)` is the reference's op: it forms
b = sqrt(clip(1 - a², 0, 1)) · gated_x in float32 (a = exp(log_a)), casts b
to gated_x's dtype, and scans. `rglru_scan(log_a, b)` is the kernel's
contract: on CUDA tensors it launches the hand-written kernel, on CPU
tensors it computes the plain version (`ref.py`); it never catches an error
to fall back. `rglru_scan.launches` counts kernel launches (plain calls do
not count). The kernel takes S and E as they are: the reference wrapper's
halving of its chunk and channel blocks until they divide is a TPU artefact.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru import rglru as _cuda
from repro_torch.kernels.rglru.ref import rglru_ref


def _check(log_a, b) -> None:
    if log_a.dim() != 3 or b.shape != log_a.shape:
        raise ValueError(f"rglru_scan: log_a and b must share [B,S,E], got "
                         f"{tuple(log_a.shape)} and {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"rglru_scan: log_a must be float32 and b float32 or bfloat16, got "
                        f"{log_a.dtype} and {b.dtype}")
    if b.device != log_a.device:
        raise ValueError(f"rglru_scan: b on {b.device}, log_a on {log_a.device}")


def rglru_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t, h_{-1} = 0. log_a: [B,S,E] float32;
    b: [B,S,E] -> h [B,S,E] in b's dtype."""
    _check(log_a, b)
    if b.device.type == "cpu":
        return rglru_ref(log_a, b)
    if b.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {b.device}")
    _cuda.entry()  # a library that cannot build or load raises before any work
    la, bc = log_a.contiguous(), b.contiguous()
    out = torch.empty_like(bc)
    _cuda.launch(la, bc, out)
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def rglru(log_a, gated_x):
    """Full RG-LRU sequence: h_t = a_t h_{t-1} + sqrt(1 - a_t²) (i·x)_t.
    log_a: [B,S,E] (already -c·softplus(lam)·r); gated_x = i·x."""
    a = torch.exp(log_a.float())
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * gated_x.float()
    return rglru_scan(log_a.float(), b.to(gated_x.dtype))
