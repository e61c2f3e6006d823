"""The mLSTM wrapper: checks, the forget-gate cumsum, allocation, launch,
count.

On CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `mlstm.launches` counts kernel launches (plain calls do not count),
and `mlstm.launches_by_dtype` splits them by dtype: bfloat16 launches run
the tensor-core (wgmma) kernel, float32 ones the CUDA-core kernel. The
kernel has no backward yet: on the card a call that would need a gradient
raises `not_ported` (ROADMAP.md §A item A7); on the CPU the plain version
is differentiable as it is. The
kernel computes in float32 and writes h in v's dtype, so bf16 heads from
the model are passed as they are.
As the reference's `mlstm_chunk` does, the wrapper forms F = cumsum(logf)
in float32, so the kernel reads two [S] gate rows per tile instead of an
[S, S] decay matrix. The kernel takes dh as it is (up to 256) and S as it
is, masking the ragged edge: the reference wrapper's halving of its blocks
until they divide S is a TPU artefact.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mlstm import mlstm as _cuda
from repro_torch.kernels.mlstm.ref import mlstm_ref
from repro_torch.unported import not_ported

MAX_HEAD_DIM = 256


def _check(q, k, v, logi, logf) -> None:
    if q.dim() != 4:
        raise ValueError(f"mlstm: q must be [B,H,S,dh], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm: q, k, v must share [B,H,S,dh] = {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if logi.shape != q.shape[:3] or logf.shape != q.shape[:3]:
        raise ValueError(f"mlstm: logi/logf must be [B,H,S] = {tuple(q.shape[:3])}, got "
                         f"{tuple(logi.shape)} and {tuple(logf.shape)}")
    if not 0 < q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"mlstm: head dim {q.shape[-1]} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _cuda.DTYPE_CODES or {k.dtype, v.dtype} != {q.dtype}:
        raise TypeError(f"mlstm: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("k", k), ("v", v), ("logi", logi), ("logf", logf)):
        if x.device != q.device:
            raise ValueError(f"mlstm: {name} on {x.device}, q on {q.device}")


def mlstm(q, k, v, logi, logf):
    """Stabilized chunkwise mLSTM. q/k/v: [B,H,S,dh]; logi/logf (log input
    gate, log sigmoid forget gate): [B,H,S] -> h [B,H,S,dh] in v's dtype."""
    _check(q, k, v, logi, logf)
    if q.device.type == "cpu":
        return mlstm_ref(q, k, v, logi, logf)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, logi, logf)):
        raise not_ported("a gradient through the mLSTM kernel (B5's backward)", "A7")
    _cuda.entry()  # a library that cannot build or load raises before any work
    F = torch.cumsum(logf.float(), dim=-1).contiguous()
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    out = torch.empty_like(vc)
    _cuda.launch(qc, kc, vc, F, logi.float().contiguous(), out, q.shape[-1] ** -0.5)
    mlstm.launches += 1
    mlstm.launches_by_dtype[str(q.dtype)[6:]] += 1
    return out


def reset_launches() -> None:
    """Zero both launch counts."""
    mlstm.launches = 0
    mlstm.launches_by_dtype = {"float32": 0, "bfloat16": 0}


reset_launches()
