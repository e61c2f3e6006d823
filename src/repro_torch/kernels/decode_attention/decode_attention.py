"""ctypes binding of the CUDA decode-attention kernel
(`csrc/decode_attention.cu`).

`launch` takes tensors already checked by `ops.decode`; the library is
built and loaded at the first launch, never at import.
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
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch(q, k_cache, v_cache, valid, out, scale: float, logit_cap: float) -> None:
    """Enqueue one kernel on the current stream of the tensors' device.
    q/out [B,H,dh], caches [B,Sc,KV,dh], valid [B,Sc] bool (read as bytes);
    `logit_cap` <= 0: no cap."""
    B, H, dh = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    fn = entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, H, KV, Sc, dh, scale, float(logit_cap), DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
