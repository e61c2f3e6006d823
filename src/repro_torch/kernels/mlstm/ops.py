"""The mLSTM wrapper: checks, the forget-gate cumsum, allocation, launch,
count.

On CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `mlstm.launches` counts kernel launches (plain calls do not count),
and `mlstm.launches_by_dtype` splits them by dtype: bfloat16 launches run
the tensor-core (wgmma) kernel, float32 ones the CUDA-core kernel. The
kernel computes in float32 and writes h in v's dtype, so bf16 heads from
the model are passed as they are.
As the reference's `mlstm_chunk` does, the wrapper forms F = cumsum(logf)
in float32, so the kernel reads two [S] gate rows per tile instead of an
[S, S] decay matrix. The kernel takes dh as it is (up to 256) and S as it
is, masking the ragged edge: the reference wrapper's halving of its blocks
until they divide S is a TPU artefact.

`mlstm` is differentiable: when grad mode is on and an input requires a
gradient, it runs as the `torch.autograd.Function` `_Mlstm`, whose forward
is the same launch (or plain call) with the rows' statistics m and n as
further outputs (float32 [B,H,S], written by the kernel's epilogue; n
signed by σ where |σ| sets it) and whose backward is `mlstm_bwd`: the
hand-written backward (`csrc/mlstm_chunk_bwd.cu`: a row pass for c, then
bfloat16 on wgmma, a dK / dV / dlogi kernel and a dQ / dF kernel, float32
on the CUDA cores; no atomics, two calls give the same bits) on CUDA
tensors, `ref.mlstm_bwd_ref` on CPU tensors. It saves q, k, v, logi, the
forward's own F, h, m and n; dlogf is the reverse cumsum of dF, formed here
as the forward's cumsum is. `mlstm_bwd.launches` counts its
calls on the card. A backward library that cannot build or load raises
before the forward's work; nothing falls back to autograd through the
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.device import plain_device
from repro_torch.kernels.mlstm import mlstm as _cuda
from repro_torch.kernels.mlstm import mlstm_bwd as _cuda_bwd
from repro_torch.kernels.mlstm.ref import mlstm_bwd_ref, mlstm_ref

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


def _forward(q, k, v, logi, logf, with_stats=False):
    """One launch (or plain call); returns (h, the contiguous q, k, v, logi
    and F it read, and with `with_stats` the rows' m and n, else None)."""
    F = torch.cumsum(logf.float(), dim=-1).contiguous()
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    li = logi.float().contiguous()
    if plain_device(q):
        if with_stats:
            return (*mlstm_ref(q, k, v, logi, logf, with_stats=True), (qc, kc, vc, li, F))
        return mlstm_ref(q, k, v, logi, logf), None, None, (qc, kc, vc, li, F)
    out = torch.empty_like(vc)
    m = n = None
    if with_stats:
        m, n = (q.new_empty(q.shape[:3], dtype=torch.float32) for _ in range(2))
    _cuda.launch(qc, kc, vc, F, li, out, q.shape[-1] ** -0.5, m=m, n=n)
    mlstm.launches += 1
    mlstm.launches_by_dtype[str(q.dtype)[6:]] += 1
    return out, m, n, (qc, kc, vc, li, F)


class _Mlstm(torch.autograd.Function):
    """`mlstm` with a gradient: the forward's launch, then `mlstm_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf):
        out, m, n, saved = _forward(q, k, v, logi, logf, with_stats=True)
        ctx.save_for_backward(*saved, out, m, n)
        ctx.gate_dtypes = (logi.dtype, logf.dtype)
        return out

    @staticmethod
    def backward(ctx, dh):
        q, k, v, li, F, out, m, n = ctx.saved_tensors
        dq, dk, dv, dlogi, dF = mlstm_bwd(q, k, v, li, F, out, dh, m, n)
        dlogf = torch.flip(torch.cumsum(torch.flip(dF, (-1,)), dim=-1), (-1,))
        di, df = ctx.gate_dtypes
        return dq, dk, dv, dlogi.to(di), dlogf.to(df)


def mlstm(q, k, v, logi, logf):
    """Stabilized chunkwise mLSTM. q/k/v: [B,H,S,dh]; logi/logf (log input
    gate, log sigmoid forget gate): [B,H,S] -> h [B,H,S,dh] in v's dtype.
    Differentiable in every input (`_Mlstm`) when grad mode is on and one
    of them requires a gradient."""
    _check(q, k, v, logi, logf)
    if not plain_device(q) and q.device.type != "cuda":
        raise ValueError(f"mlstm: no kernel for device {q.device}")
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, logi, logf))
    if q.device.type == "cuda":
        _cuda.entry()  # a library that cannot build or load raises before any work
        if grad:
            _cuda_bwd.entry()  # the backward's library too, before the forward's work
    if grad:
        return _Mlstm.apply(q, k, v, logi, logf)
    if plain_device(q):
        return mlstm_ref(q, k, v, logi, logf)
    return _forward(q, k, v, logi, logf)[0]


def mlstm_bwd(q, k, v, logi, F, h, dh, m, n):
    """The gradient of the kernel's function: q/k/v [B,H,S,dh], logi and the
    forward's F = cumsum(logf) [B,H,S] float32, the forward's output h and
    its gradient dh [B,H,S,dh], the forward's row statistics m and n
    [B,H,S] float32 -> (dq, dk, dv) in q's dtype and (dlogi, dF) float32. On
    CUDA tensors one call of the backward's entry point (its kernels; a
    float32 workspace for the rows' c), counted in `mlstm_bwd.launches`; on
    CPU tensors `mlstm_bwd_ref`."""
    _check(q, k, v, logi, F)
    if h.shape != q.shape or dh.shape != q.shape:
        raise ValueError(f"mlstm_bwd: h and dh must be {tuple(q.shape)}, got {tuple(h.shape)} "
                         f"and {tuple(dh.shape)}")
    if {h.dtype, dh.dtype} != {q.dtype} or {h.device, dh.device} != {q.device}:
        raise TypeError("mlstm_bwd: h and dh must share q's dtype and device")
    for name, x in (("m", m), ("n", n)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"mlstm_bwd: {name} must be float32 {tuple(q.shape[:3])} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if plain_device(q):
        return mlstm_bwd_ref(q, k, v, logi, F, h, dh, m, n)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_bwd: no kernel for device {q.device}")
    _cuda_bwd.entry()
    q, k, v, h, dh, m, n = (x.contiguous() for x in (q, k, v, h, dh, m, n))
    li, Fc = logi.float().contiguous(), F.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dlogi, dF = torch.empty_like(li), torch.empty_like(Fc)
    _cuda_bwd.launch(q, k, v, h, dh, Fc, li, m, n, dq, dk, dv, dlogi, dF, q.shape[-1] ** -0.5)
    mlstm_bwd.launches += 1
    mlstm_bwd.launches_by_dtype[str(q.dtype)[6:]] += 1
    return dq, dk, dv, dlogi, dF


def reset_launches() -> None:
    """Zero the launch counts (the forward's and the backward's)."""
    mlstm.launches = 0
    mlstm.launches_by_dtype = {"float32": 0, "bfloat16": 0}
    mlstm_bwd.launches = 0
    mlstm_bwd.launches_by_dtype = {"float32": 0, "bfloat16": 0}


reset_launches()
