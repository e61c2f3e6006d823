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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

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


def mha(q, k, v, *, causal: bool = True, window: int = 0, chunk_local: bool = False,
        logit_cap: float = 0.0):
    """q: [B,S,H,dh], k: [B,Sk,KV,dh], v: [B,Sk,KV,dv] -> [B,S,H,dv] in q's
    dtype. Sk != S (cross-attention) only with causal=False and window=0,
    as the reference's `chunked_attention` asserts."""
    _check(q, k, v)
    if window < 0 or logit_cap < 0:
        raise ValueError(f"mha: window and logit_cap must be >= 0, got {window}, {logit_cap}")
    cross = k.shape[1] != q.shape[1]
    if cross and (causal or window):
        raise ValueError(f"mha: causal or windowed attention needs q_len == kv_len, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha: no kernel for device {q.device}")
    if q.device.type == "cuda":
        _cuda.entry()  # a library that cannot build or load raises before any work
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if q.device.type == "cpu":
        out = attention_ref(qt, kt, vt, causal=causal, window=window, chunk_local=chunk_local,
                            logit_cap=logit_cap)
    else:
        out = qt.new_empty(qt.shape[:3] + (v.shape[-1],))
        _cuda.launch(qt, kt, vt, out, q.shape[-1] ** -0.5, causal, window, chunk_local,
                     logit_cap)
        mha.launches += 1
        mha.launches_by_dtype[str(q.dtype)[6:]] += 1
        mha.cross_launches += cross
    return out.transpose(1, 2)


def reset_launches() -> None:
    """Zero the launch counts."""
    mha.launches = 0
    mha.launches_by_dtype = {"float32": 0, "bfloat16": 0}
    mha.cross_launches = 0


reset_launches()
