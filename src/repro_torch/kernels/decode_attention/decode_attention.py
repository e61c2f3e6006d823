"""ctypes binding of the CUDA decode-attention kernel
(`csrc/decode_attention.cu`).

`launch_args` takes tensors already checked by `ops.decode`; the library is
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
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch_args(q, k_cache, v_cache, valid, out, scratch, scale: float, logit_cap: float,
                splits: int, per: int) -> tuple:
    """The C entry point's arguments, on the current stream of q's device:
    q/out [B,H,dh], caches [B,Sc,KV,dh], valid [B,Sc] bool (read as bytes),
    scratch float32 of B·H·splits·(dh + 2); `splits` blocks of `per` slots
    cover the cache; `logit_cap` <= 0: no cap."""
    B, H, dh = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, H, KV, Sc, dh, scale, float(logit_cap),
            splits, per, DTYPE_CODES[q.dtype], stream)


def run(args: tuple) -> None:
    """Enqueue the split kernel and its merge (two CUDA launches) with
    `launch_args`'s arguments."""
    err = entry()(*args)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
