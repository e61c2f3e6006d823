"""ctypes binding of the CUDA flash-attention backward
(`csrc/flash_attention_bwd.cu`).

`launch` takes tensors already checked by `ops.mha_backward`; the library is
built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.flash_attention import DTYPE_CODES


@functools.lru_cache(maxsize=None)
def entry():
    """The C entry point; the library is built at the first call."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, o, dout, dq, dk, dv, lse, delta, scale: float, causal: bool, window: int,
           chunk_local: bool, logit_cap: float) -> None:
    """Enqueue the three kernels on the current stream of the tensors'
    device. q [B,H,S,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dout
    [B,H,S,dv] -> dq, dk, dv of their shapes; lse and delta float32 [B,H,S]
    workspaces; `logit_cap` <= 0: no cap."""
    B, H, S, dh = q.shape
    KV, Sk, dvd = k.shape[1], k.shape[2], v.shape[3]
    fn = entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            B, H, KV, S, Sk, dh, dvd, scale, float(logit_cap), int(causal), int(window),
            int(chunk_local), DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
