"""ctypes binding of the CUDA RG-LRU kernel (`csrc/rglru_scan.cu`).

`launch` takes tensors already checked by `ops.rglru_scan` / `ops.rglru`;
the library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def entry():
    """The library with its C entry points typed; built at the first call."""
    lib = _build.load("rglru_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.rglru_launch.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.rglru_workspace_bytes.argtypes = [i32, i32]
    lib.rglru_workspace_bytes.restype = ctypes.c_longlong
    for fn in (lib.rglru_scan_launch, lib.rglru_launch):
        fn.restype = i32
    return lib


def launch(log_a, x, out, h0=None, fused=False) -> None:
    """Enqueue the workspace reset and one kernel on the current stream of
    the tensors' device. log_a [B,S,E] float32; x (b, or gx when `fused`)
    and out [B,S,E] float32 or bfloat16; h0 [B,E] float32 or None (fused
    only)."""
    B, S, E = x.shape
    lib = entry()
    ws = torch.empty(lib.rglru_workspace_bytes(B, E), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if fused:
            err = lib.rglru_launch(log_a.data_ptr(), x.data_ptr(),
                                   None if h0 is None else h0.data_ptr(), out.data_ptr(),
                                   ws.data_ptr(), B, S, E, DTYPE_CODES[x.dtype], stream)
        else:
            err = lib.rglru_scan_launch(log_a.data_ptr(), x.data_ptr(), out.data_ptr(),
                                        ws.data_ptr(), B, S, E, DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: cudaError {err}")
