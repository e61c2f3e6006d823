"""ctypes binding of the CUDA mLSTM backward (`csrc/mlstm_chunk_bwd.cu`).

`launch` takes tensors already checked by `ops.mlstm_bwd`; the library is
built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm.mlstm import DTYPE_CODES


@functools.lru_cache(maxsize=None)
def entry():
    """The library with its C entry points typed; built at the first call."""
    lib = _build.load("mlstm_chunk_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mlstm_chunk_bwd_launch.argtypes = [ptr] * 15 + [i32] * 3 + [ctypes.c_float, i32, ptr]
    lib.mlstm_chunk_bwd_launch.restype = i32
    lib.mlstm_chunk_bwd_workspace_bytes.argtypes = [i32, i32]
    lib.mlstm_chunk_bwd_workspace_bytes.restype = ctypes.c_longlong
    return lib


def launch(q, k, v, h, dh, F, logi, m, n, dq, dk, dv, dlogi, dF, scale: float) -> None:
    """Enqueue the backward's kernels on the current stream of the tensors'
    device. q/k/v, the forward's output h and its gradient dh, and dq/dk/dv
    [B,H,S,d]; F, logi, the forward's m and n, dlogi and dF [B,H,S]
    float32; the float32 workspace (the rows' c) is allocated here."""
    B, H, S, d = q.shape
    lib = entry()
    ws = torch.empty(lib.mlstm_chunk_bwd_workspace_bytes(B * H, S), dtype=torch.uint8,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), h.data_ptr(), dh.data_ptr(), F.data_ptr(),
            logi.data_ptr(), m.data_ptr(), n.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dlogi.data_ptr(), dF.data_ptr(), ws.data_ptr(), B * H, S, d, scale,
            DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"mlstm_chunk_bwd kernel launch failed: cudaError {err}")
