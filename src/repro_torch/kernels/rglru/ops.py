"""The RG-LRU wrappers: checks, allocation, launch, count.

`rglru(log_a, gated_x, h0=None)` is the reference's op: b = sqrt(clip(1 -
a², 0, 1)) · gated_x in float32 (a = exp(log_a)), cast to gated_x's dtype,
then the scan from the carry h0 (zero if None). On CUDA tensors one kernel
launch does all of it (the b formation fused into the scan); on CPU tensors
it runs the plain composition (`ref.gated_input`, then `rglru_scan`, or
`rglru_ref` from h0).
`rglru_scan(log_a, b)` is the TPU kernel's contract: on CUDA tensors the
same kernel with b given, on CPU tensors the plain version (`ref.py`).
Neither ever catches an error to fall back. `rglru.launches` and
`rglru_scan.launches` count kernel launches of each entry (plain calls do
not count). The kernel takes S and E as they are: the reference wrapper's
halving of its chunk and channel blocks until they divide is a TPU
artefact.

Both are differentiable: when grad mode is on and an input requires a
gradient, each runs as a `torch.autograd.Function` (`_Rglru`,
`_RglruScan`) whose forward is the same launch (or plain call) and whose
backward is `rglru_bwd`: the hand-written reverse scan
(`csrc/rglru_scan_bwd.cu`, b's formation differentiated in it for the
op) on CUDA tensors, `ref.rglru_bwd_ref` on CPU tensors. It reads h_{t-1}
from the saved output. `rglru_bwd.launches` counts its launches on the
card. A backward library that cannot build or load raises before the
forward's work; nothing falls back to autograd through the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.device import plain_device
from repro_torch.kernels.rglru import rglru as _cuda
from repro_torch.kernels.rglru import rglru_bwd as _cuda_bwd
from repro_torch.kernels.rglru.ref import gated_input, rglru_bwd_ref, rglru_ref


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


def _needs_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs)


def _kernel_device(x, name, grad) -> None:
    """Raise unless x is on a device with a kernel; on CUDA, build and load
    the forward's library (and, with `grad`, the backward's) before any
    work, so one that cannot load raises first."""
    if plain_device(x):
        return
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _cuda.entry()
    if grad:
        _cuda_bwd.entry()


def _scan(la, bc):
    """One launch of the contract (or its plain call) on contiguous tensors."""
    if plain_device(bc):
        return rglru_ref(la, bc)
    out = torch.empty_like(bc)
    _cuda.launch(la, bc, out)
    rglru_scan.launches += 1
    return out


def _op(la, gx, h0):
    """One launch of the fused op (or the plain composition) on contiguous
    tensors."""
    if plain_device(gx):
        b = gated_input(la, gx)
        return rglru_scan(la, b) if h0 is None else rglru_ref(la, b, h0)
    out = torch.empty_like(gx)
    _cuda.launch(la, gx, out, h0=h0, fused=True)
    rglru.launches += 1
    return out


def _contiguous(*xs):
    return tuple(None if x is None else x.contiguous() for x in xs)


class _RglruScan(torch.autograd.Function):
    """`rglru_scan` with a gradient: the forward's launch, then `rglru_bwd`."""

    @staticmethod
    def forward(ctx, log_a, b):
        la, bc = _contiguous(log_a, b)
        out = _scan(la, bc)
        ctx.save_for_backward(la, bc, out)
        return out

    @staticmethod
    def backward(ctx, dh):
        la, bc, out = ctx.saved_tensors
        return rglru_bwd(la, bc, out, dh)[:2]


class _Rglru(torch.autograd.Function):
    """`rglru` with a gradient: the fused launch, then `rglru_bwd(fused=True)`."""

    @staticmethod
    def forward(ctx, log_a, gx, h0):
        la, gc, hc = _contiguous(log_a, gx, h0)
        out = _op(la, gc, hc)
        ctx.save_for_backward(la, gc, hc, out)
        return out

    @staticmethod
    def backward(ctx, dh):
        la, gc, hc, out = ctx.saved_tensors
        return rglru_bwd(la, gc, out, dh, h0=hc, fused=True)


def rglru_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t, h_{-1} = 0. log_a: [B,S,E] float32;
    b: [B,S,E] -> h [B,S,E] in b's dtype. Differentiable in log_a and b
    (`_RglruScan`) when grad mode is on and one of them requires a
    gradient."""
    _check(log_a, b)
    grad = _needs_grad(log_a, b)
    _kernel_device(b, "rglru_scan", grad)
    if grad:
        return _RglruScan.apply(log_a, b)
    return _scan(*_contiguous(log_a, b))


rglru_scan.launches = 0


def rglru(log_a, gated_x, h0=None):
    """Full RG-LRU sequence: h_t = a_t h_{t-1} + sqrt(1 - a_t²) (i·x)_t,
    h_{-1} = h0 (float32 [B,E]) or 0. log_a: [B,S,E] (already
    -c·softplus(lam)·r); gated_x = i·x, float32 or bfloat16 -> h [B,S,E] in
    gated_x's dtype. Differentiable in log_a, gated_x and h0 (`_Rglru`)
    when grad mode is on and one of them requires a gradient."""
    log_a = log_a.float()
    _check(log_a, gated_x, h0, "rglru")
    grad = _needs_grad(log_a, gated_x, h0)
    _kernel_device(gated_x, "rglru", grad)
    if grad:
        return _Rglru.apply(log_a, gated_x, h0)
    return _op(*_contiguous(log_a, gated_x, h0))


rglru.launches = 0


def rglru_bwd(log_a, x, h, dh, h0=None, fused=False):
    """The gradient of `rglru_scan` (x = b) or, `fused`, of `rglru` (x =
    gx): log_a [B,S,E] float32, x, the forward's output h and its gradient
    dh [B,S,E] in x's dtype, h0 the fused op's carry [B,E] float32 or None
    -> (dlog_a, db or dgx, dh0 or None). On CUDA tensors one launch of the
    backward kernel, counted in `rglru_bwd.launches`; on CPU tensors
    `rglru_bwd_ref`."""
    _check(log_a, x, h0, "rglru_bwd")
    if h.shape != x.shape or dh.shape != x.shape:
        raise ValueError(f"rglru_bwd: h and dh must be {tuple(x.shape)}, got {tuple(h.shape)} "
                         f"and {tuple(dh.shape)}")
    if {h.dtype, dh.dtype} != {x.dtype} or {h.device, dh.device} != {x.device}:
        raise TypeError("rglru_bwd: h and dh must share x's dtype and device")
    if h0 is not None and not fused:
        raise ValueError("rglru_bwd: h0 belongs to the fused op")
    if plain_device(x):
        return rglru_bwd_ref(log_a, x, h, dh, h0=h0, fused=fused)
    _kernel_device(x, "rglru_bwd", True)
    la, xc, hc, dhc, h0c = _contiguous(log_a, x, h, dh, h0)
    dla, dx = torch.empty_like(la), torch.empty_like(xc)
    dh0 = None if h0c is None else torch.empty_like(h0c)
    _cuda_bwd.launch(la, xc, hc, dhc, dla, dx, h0=h0c, dh0=dh0, fused=fused)
    rglru_bwd.launches += 1
    return dla, dx, dh0


rglru_bwd.launches = 0
