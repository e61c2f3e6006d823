"""ctypes binding of the CUDA RG-LRU backward (`csrc/rglru_scan_bwd.cu`).

`launch` takes tensors already checked by `ops.rglru_bwd`; the library is
built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.rglru import DTYPE_CODES


@functools.lru_cache(maxsize=None)
def entry():
    """The library with its C entry points typed; built at the first call."""
    lib = _build.load("rglru_scan_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_bwd_launch.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.rglru_bwd_launch.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    lib.rglru_bwd_workspace_bytes.argtypes = [i32, i32]
    lib.rglru_bwd_workspace_bytes.restype = ctypes.c_longlong
    for fn in (lib.rglru_scan_bwd_launch, lib.rglru_bwd_launch):
        fn.restype = i32
    return lib


def launch(log_a, x, h, dh, dlog_a, dx, h0=None, dh0=None, fused=False) -> None:
    """Enqueue the workspace reset and one kernel on the current stream of
    the tensors' device. log_a and dlog_a [B,S,E] float32; x (b, or gx when
    `fused`), the forward's output h, its gradient dh and dx [B,S,E] float32
    or bfloat16; h0 and dh0 [B,E] float32 or None (fused only)."""
    B, S, E = x.shape
    lib = entry()
    ws = torch.empty(lib.rglru_bwd_workspace_bytes(B, E), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if fused:
            err = lib.rglru_bwd_launch(log_a.data_ptr(), x.data_ptr(), h.data_ptr(),
                                       dh.data_ptr(), None if h0 is None else h0.data_ptr(),
                                       dlog_a.data_ptr(), dx.data_ptr(),
                                       None if dh0 is None else dh0.data_ptr(), ws.data_ptr(),
                                       B, S, E, DTYPE_CODES[x.dtype], stream)
        else:
            err = lib.rglru_scan_bwd_launch(log_a.data_ptr(), x.data_ptr(), h.data_ptr(),
                                            dh.data_ptr(), dlog_a.data_ptr(), dx.data_ptr(),
                                            ws.data_ptr(), B, S, E, DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rglru backward kernel launch failed: cudaError {err}")
