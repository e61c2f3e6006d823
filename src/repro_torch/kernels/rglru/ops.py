"""The RG-LRU wrappers: checks, allocation, launch, count.

`rglru(log_a, gated_x, h0=None)` is the reference's op: b = sqrt(clip(1 -
a², 0, 1)) · gated_x in float32 (a = exp(log_a)), cast to gated_x's dtype,
then the scan from the carry h0 (zero if None). On CUDA tensors one kernel
launch does all of it (the b formation fused into the scan); on CPU tensors
it runs the plain composition (`ref.gated_input`, then `rglru_scan`, or
`rglru_ref` from h0). `rglru_scan(log_a, b)` is the TPU kernel's contract:
on CUDA tensors the same kernel with b given, on CPU tensors the plain
version (`ref.py`). Neither ever catches an error to fall back.
`rglru.launches` and `rglru_scan.launches` count kernel launches of each
entry (plain calls do not count). The kernel takes S and E as they are: the
reference wrapper's halving of its chunk and channel blocks until they
divide is a TPU artefact. The kernel has no backward yet: on the card a
call that would need a gradient raises `not_ported` (ROADMAP.md §A item
A7); on the CPU the plain version is differentiable as it is.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru import rglru as _cuda
from repro_torch.kernels.rglru.ref import gated_input, rglru_ref
from repro_torch.unported import not_ported


def _check(log_a, b, h0=None, name="rglru_scan") -> None:
    if log_a.dim() != 3 or b.shape != log_a.shape:
        raise ValueError(f"{name}: log_a and b must share [B,S,E], got "
                         f"{tuple(log_a.shape)} and {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"{name}: log_a must be float32 and b float32 or bfloat16, got "
                        f"{log_a.dtype} and {b.dtype}")
    if b.device != log_a.device:
        raise ValueError(f"{name}: b on {b.device}, log_a on {log_a.device}")
    if h0 is None:
        return
    B, _, E = log_a.shape
    if h0.shape != (B, E):
        raise ValueError(f"{name}: h0 must be [B,E] = {(B, E)}, got {tuple(h0.shape)}")
    if h0.dtype != torch.float32:
        raise TypeError(f"{name}: h0 must be float32 (the carry), got {h0.dtype}")
    if h0.device != log_a.device:
        raise ValueError(f"{name}: h0 on {h0.device}, log_a on {log_a.device}")


def _kernel_device(x, name, *inputs) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise not_ported("a gradient through the RG-LRU kernel (B4's backward)", "A7")
    _cuda.entry()  # a library that cannot build or load raises before any work


def rglru_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t, h_{-1} = 0. log_a: [B,S,E] float32;
    b: [B,S,E] -> h [B,S,E] in b's dtype."""
    _check(log_a, b)
    if b.device.type == "cpu":
        return rglru_ref(log_a, b)
    _kernel_device(b, "rglru_scan", log_a, b)
    la, bc = log_a.contiguous(), b.contiguous()
    out = torch.empty_like(bc)
    _cuda.launch(la, bc, out)
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def rglru(log_a, gated_x, h0=None):
    """Full RG-LRU sequence: h_t = a_t h_{t-1} + sqrt(1 - a_t²) (i·x)_t,
    h_{-1} = h0 (float32 [B,E]) or 0. log_a: [B,S,E] (already
    -c·softplus(lam)·r); gated_x = i·x, float32 or bfloat16 -> h [B,S,E] in
    gated_x's dtype."""
    log_a = log_a.float()
    _check(log_a, gated_x, h0, "rglru")
    if gated_x.device.type == "cpu":
        b = gated_input(log_a, gated_x)
        return rglru_scan(log_a, b) if h0 is None else rglru_ref(log_a, b, h0)
    _kernel_device(gated_x, "rglru", log_a, gated_x, h0)
    la, gx = log_a.contiguous(), gated_x.contiguous()
    out = torch.empty_like(gx)
    _cuda.launch(la, gx, out, h0=None if h0 is None else h0.contiguous(), fused=True)
    rglru.launches += 1
    return out


rglru.launches = 0
