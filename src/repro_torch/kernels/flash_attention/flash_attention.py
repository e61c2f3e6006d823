"""ctypes binding of the CUDA flash-attention kernel
(`csrc/flash_attention.cu`).

`launch` takes tensors already checked by `ops.mha`; the library is built
and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def entry():
    """The C entry point; the library is built at the first call."""
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, out, scale: float, causal: bool, window: int, chunk_local: bool,
           logit_cap: float, lse=None) -> None:
    """Enqueue one kernel on the current stream of the tensors' device.
    q [B,H,S,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], out [B,H,S,dv] (Sk != S:
    cross-attention, no causal or window mask); `logit_cap` <= 0: no cap;
    `lse`: None, or a float32 [B,H,S] that receives each row's
    log-sum-exp of its masked scores (what the backward needs)."""
    B, H, S, dh = q.shape
    KV, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    fn = entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, KV, S, Sk, dh, dv, scale,
            float(logit_cap), int(causal), int(window), int(chunk_local), DTYPE_CODES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
