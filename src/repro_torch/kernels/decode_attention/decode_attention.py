"""ctypes binding of the CUDA decode-attention kernel
(`csrc/decode_attention.cu`): two C entry points, one for a float32 or
bf16 cache and one for an int8 cache with float32 scales.

`launch_args` / `launch_args_int8` take tensors already checked by
`ops.decode`; the library is built and loaded at the first launch, never at
import.
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


@functools.lru_cache(maxsize=None)
def entry_int8():
    """The int8 cache's C entry point (the same library)."""
    fn = _build.load("decode_attention").decode_attention_int8_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _tail(q, k_cache, scale, logit_cap, splits, per) -> tuple:
    B, H, dh = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (B, H, KV, Sc, dh, scale, float(logit_cap), splits, per, DTYPE_CODES[q.dtype], stream)


def launch_args(q, k_cache, v_cache, valid, out, scratch, scale: float, logit_cap: float,
                splits: int, per: int) -> tuple:
    """The C entry point and its arguments, on the current stream of q's
    device: q/out [B,H,dh], caches [B,Sc,KV,dh], valid [B,Sc] bool (read
    as bytes), scratch float32 of B·H·splits·(dh + 2); `splits` blocks of
    `per` slots cover the cache; `logit_cap` <= 0: no cap."""
    return (entry(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
            out.data_ptr(), scratch.data_ptr()) + _tail(q, k_cache, scale, logit_cap, splits, per)


def launch_args_int8(q, k_cache, v_cache, k_scale, v_scale, valid, out, scratch, scale: float,
                     logit_cap: float, splits: int, per: int) -> tuple:
    """As `launch_args` for an int8 cache [B,Sc,KV,dh] and its float32
    scales [B,Sc,KV]: the kernel dequantizes each element to q's dtype
    where it would read the bf16 (or float32) cache's element."""
    return (entry_int8(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), valid.data_ptr(), out.data_ptr(),
            scratch.data_ptr()) + _tail(q, k_cache, scale, logit_cap, splits, per)


def run(args: tuple) -> None:
    """Enqueue the split kernel and its merge (two CUDA launches) with the
    entry point and arguments `launch_args` / `launch_args_int8` gave."""
    err = args[0](*args[1:])
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
