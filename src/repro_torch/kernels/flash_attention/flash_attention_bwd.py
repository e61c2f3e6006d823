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
    """The library with its C entry points typed; built at the first call."""
    lib = _build.load("flash_attention_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = (
        [ptr] * 10 + [i32] * 7 + [f32] * 2 + [i32] * 4 + [ptr])
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_workspace_bytes.argtypes = [i32] * 8
    lib.flash_attention_bwd_workspace_bytes.restype = ctypes.c_longlong
    return lib


def launch(q, k, v, o, dout, lse, dq, dk, dv, scale: float, causal: bool, window: int,
           chunk_local: bool, logit_cap: float) -> None:
    """Enqueue the backward's kernels on the current stream of the tensors'
    device. q [B,H,S,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], o and dout
    [B,H,S,dv], the forward's lse float32 [B,H,S] -> dq, dk, dv of their
    shapes; the float32 workspace (D, and the bf16 route's dK / dV partials
    when the query heads are split) is allocated here; `logit_cap` <= 0: no
    cap."""
    B, H, S, dh = q.shape
    KV, Sk, dvd = k.shape[1], k.shape[2], v.shape[3]
    lib = entry()
    code = DTYPE_CODES[q.dtype]
    ws = torch.empty(lib.flash_attention_bwd_workspace_bytes(B, H, KV, S, Sk, dh, dvd, code),
                     dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
            B, H, KV, S, Sk, dh, dvd, scale, float(logit_cap), int(causal), int(window),
            int(chunk_local), code, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
