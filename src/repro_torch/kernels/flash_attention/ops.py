"""The flash-attention wrapper: layout, checks, allocation, launch, count.

Takes the model's [B,S,H,dh] layout and hands the kernel [B,H,S,dh]. V's
head dim dv may be narrower than the Q/K head dim dh (MLA: 64 vs 96); the
output then has dv columns, and the scale stays dh^-0.5. On
CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `mha.launches` counts kernel launches (plain calls do not count),
`mha.launches_by_dtype` splits them by dtype (bfloat16 launches run the
tensor-core (wgmma) kernel, float32 ones the CUDA-core kernel) and
`mha.cross_launches` counts those with a key length of their own (Sk != S:
an encoder-decoder's cross-attention, the kernel's CROSS variants). The kernel
takes dh as it is (up to 256) and S as it is, masking the ragged edge:
the reference wrapper's padding of dh to 128 and its shrinking of the
block to divide S are TPU artefacts. `logit_cap` > 0 caps each scaled
score at `tanh(s / cap) * cap` before the mask, as the reference model's
attention does (its TPU kernel has no cap).

`mha` is differentiable: when grad mode is on and q, k or v requires a
gradient, it runs as the `torch.autograd.Function` `_Mha`, whose forward is
the same launch (or plain call) with the rows' log-sum-exp as a second
output (float32 [B,H,S], written by the kernel's epilogue) and whose
backward is `mha_backward` on the saved q, k, v, out and lse: the
hand-written backward (`csrc/flash_attention_bwd.cu`: a D pass, then
bfloat16 on wgmma, a dK / dV kernel and a dQ kernel, float32 on the CUDA
cores; no atomics, two calls give the same bits) on CUDA tensors,
`ref.attention_bwd_ref` on CPU tensors. `mha_backward.launches` counts its
calls on the card. Without a gradient `mha` takes the path it always took,
with no lse written.
"""

from __future__ import annotations

import torch

from repro_torch.device import plain_device
from repro_torch.kernels.flash_attention import flash_attention as _cuda
from repro_torch.kernels.flash_attention import flash_attention_bwd as _cuda_bwd
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

MAX_HEAD_DIM = 256


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"mha: q must be [B,S,H,dh], k [B,Sk,KV,dh] and v [B,Sk,KV,dv], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}")
    B, S, H, dh = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, Sk, KV, dh) or v.shape[:3] != (B, Sk, KV) or not 0 < dv <= dh
            or Sk == 0):
        raise ValueError(f"mha: k must be [B,Sk,KV,dh] = {(B, Sk, KV, dh)} with Sk > 0 and v "
                         f"[B,Sk,KV,dv] with 0 < dv <= dh, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"mha: H = {H} must be a multiple of KV = {KV}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"mha: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _cuda.DTYPE_CODES or {k.dtype, v.dtype} != {q.dtype}:
        raise TypeError(f"mha: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"mha: {name} on {x.device}, q on {q.device}")


def _forward(qt, kt, vt, causal, window, chunk_local, logit_cap, with_lse=False):
    """One launch (or plain call) on the kernel's layout [B,H,S,d]; with
    `with_lse`, (out, the rows' log-sum-exp float32 [B,H,S])."""
    if plain_device(qt):
        return attention_ref(qt, kt, vt, causal=causal, window=window, chunk_local=chunk_local,
                             logit_cap=logit_cap, with_lse=with_lse)
    out = qt.new_empty(qt.shape[:3] + (vt.shape[-1],))
    lse = qt.new_empty(qt.shape[:3], dtype=torch.float32) if with_lse else None
    _cuda.launch(qt, kt, vt, out, qt.shape[-1] ** -0.5, causal, window, chunk_local, logit_cap,
                 lse=lse)
    mha.launches += 1
    mha.launches_by_dtype[str(qt.dtype)[6:]] += 1
    mha.cross_launches += kt.shape[2] != qt.shape[2]
    return (out, lse) if with_lse else out


def _check_args(q, k, v, causal, window, logit_cap) -> None:
    _check(q, k, v)
    if window < 0 or logit_cap < 0:
        raise ValueError(f"mha: window and logit_cap must be >= 0, got {window}, {logit_cap}")
    if k.shape[1] != q.shape[1] and (causal or window):
        raise ValueError(f"mha: causal or windowed attention needs q_len == kv_len, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    if not plain_device(q) and q.device.type != "cuda":
        raise ValueError(f"mha: no kernel for device {q.device}")


class _Mha(torch.autograd.Function):
    """`mha` with a gradient: the forward's launch with the rows' lse, then
    `mha_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk_local, logit_cap):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out, lse = _forward(qt, kt, vt, causal, window, chunk_local, logit_cap, with_lse=True)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.mask = (causal, window, chunk_local, logit_cap)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, out, lse = ctx.saved_tensors
        causal, window, chunk_local, logit_cap = ctx.mask
        dq, dk, dv = mha_backward(qt, kt, vt, out, dout.transpose(1, 2), lse, causal=causal,
                                  window=window, chunk_local=chunk_local, logit_cap=logit_cap)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), None, None, None, None


def mha(q, k, v, *, causal: bool = True, window: int = 0, chunk_local: bool = False,
        logit_cap: float = 0.0):
    """q: [B,S,H,dh], k: [B,Sk,KV,dh], v: [B,Sk,KV,dv] -> [B,S,H,dv] in q's
    dtype. Sk != S (cross-attention) only with causal=False and window=0,
    as the reference's `chunked_attention` asserts. Differentiable in q, k
    and v (`_Mha`) when grad mode is on and one of them requires a gradient."""
    _check_args(q, k, v, causal, window, logit_cap)
    if q.device.type == "cuda":
        _cuda.entry()  # a library that cannot build or load raises before any work
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cuda":
            _cuda_bwd.entry()  # the backward's library too, before the forward's work
        return _Mha.apply(q, k, v, causal, window, chunk_local, logit_cap)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _forward(qt, kt, vt, causal, window, chunk_local, logit_cap).transpose(1, 2)


def mha_backward(q, k, v, out, dout, lse, *, causal: bool = True, window: int = 0,
                 chunk_local: bool = False, logit_cap: float = 0.0):
    """The gradient of the kernel's function on its layout: q [B,H,S,dh],
    k [B,KV,Sk,dh], v [B,KV,Sk,dv], the forward's out and its gradient dout
    [B,H,S,dv] and the forward's row log-sum-exp lse float32 [B,H,S] ->
    (dq, dk, dv) in q's dtype. On CUDA tensors one call of the backward's
    entry point (its kernels; a float32 workspace for D and the split
    partials), counted in `mha_backward.launches`; on CPU tensors
    `attention_bwd_ref`."""
    _check_args(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal, window,
                logit_cap)
    if out.shape != q.shape[:3] + (v.shape[-1],) or dout.shape != out.shape:
        raise ValueError(f"mha_backward: out and dout must be {q.shape[:3] + (v.shape[-1],)}, "
                         f"got {tuple(out.shape)} and {tuple(dout.shape)}")
    if {out.dtype, dout.dtype} != {q.dtype} or {out.device, dout.device} != {q.device}:
        raise TypeError("mha_backward: out and dout must share q's dtype and device")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"mha_backward: lse must be float32 {tuple(q.shape[:3])} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if plain_device(q):
        return attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window,
                                 chunk_local=chunk_local, logit_cap=logit_cap)
    _cuda_bwd.entry()
    q, k, v, out, dout, lse = (x.contiguous() for x in (q, k, v, out, dout, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _cuda_bwd.launch(q, k, v, out, dout, lse, dq, dk, dv, q.shape[-1] ** -0.5, causal, window,
                     chunk_local, logit_cap)
    mha_backward.launches += 1
    mha_backward.launches_by_dtype[str(q.dtype)[6:]] += 1
    return dq, dk, dv


def reset_launches() -> None:
    """Zero the launch counts (the forward's and the backward's)."""
    mha.launches = 0
    mha.launches_by_dtype = {"float32": 0, "bfloat16": 0}
    mha.cross_launches = 0
    mha_backward.launches = 0
    mha_backward.launches_by_dtype = {"float32": 0, "bfloat16": 0}


reset_launches()
