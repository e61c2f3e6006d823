"""ctypes binding of the CUDA RG-LRU kernel (`csrc/rglru_scan.cu`).

`launch` takes tensors already checked by `ops.rglru_scan`; the library is
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
    fn = _build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(log_a, b, out) -> None:
    """Enqueue one kernel on the current stream of the tensors' device.
    log_a [B,S,E] float32, b/out [B,S,E] float32 or bfloat16."""
    B, S, E = b.shape
    fn = entry()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(log_a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, E,
                 DTYPE_CODES[b.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
