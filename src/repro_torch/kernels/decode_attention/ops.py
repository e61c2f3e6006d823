"""The decode-attention wrapper: checks, allocates, launches, counts.

On CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `decode.launches` counts kernel launches (plain calls do not count),
so a run can show that its main path went through the kernel. The kernel
takes dh as it is (up to 256) and scales by 1/sqrt(dh) itself: the
reference wrapper's padding of dh to 128 is a TPU matrix-unit artefact.
`logit_cap` > 0 caps each scaled score at `tanh(s / cap) * cap` before the
mask, as the reference model's attention does (its TPU kernel has no cap).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention as _cuda
from repro_torch.kernels.decode_attention.ref import decode_ref

MAX_HEAD_DIM = 256


def _check(q, k_cache, v_cache, valid) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"decode: q must be [B,H,dh] and caches [B,Sc,KV,dh], got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
    B, H, dh = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, Sc, KV, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode: caches must be [B,Sc,KV,dh] = {(B, Sc, KV, dh)}, got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    if valid.shape != (B, Sc) or valid.dtype != torch.bool:
        raise ValueError(f"decode: valid must be bool [B,Sc] = {(B, Sc)}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"decode: H = {H} must be a multiple of KV = {KV}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _cuda.DTYPE_CODES or {k_cache.dtype, v_cache.dtype} != {q.dtype}:
        raise TypeError(f"decode: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("valid", valid)):
        if x.device != q.device:
            raise ValueError(f"decode: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"decode: {name} must be contiguous")


def decode(q, k_cache, v_cache, valid, *, logit_cap: float = 0.0):
    """q: [B,1,H,dh] or [B,H,dh]; caches [B,Sc,KV,dh]; valid [B,Sc] bool ->
    q's shape and dtype."""
    if logit_cap < 0:
        raise ValueError(f"decode: logit_cap must be >= 0, got {logit_cap}")
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    _check(q, k_cache, v_cache, valid)
    if q.device.type == "cpu":
        out = decode_ref(q, k_cache, v_cache, valid, logit_cap=logit_cap)
    elif q.device.type == "cuda":
        _cuda.entry()  # a library that cannot build or load raises before any work
        out = torch.empty_like(q)
        _cuda.launch(q, k_cache, v_cache, valid, out, q.shape[-1] ** -0.5, logit_cap)
        decode.launches += 1
    else:
        raise ValueError(f"decode: no kernel for device {q.device}")
    return out[:, None] if squeeze else out


decode.launches = 0
