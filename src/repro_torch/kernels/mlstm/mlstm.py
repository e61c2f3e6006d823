"""ctypes binding of the CUDA mLSTM kernel (`csrc/mlstm_chunk.cu`).

`launch` takes tensors already checked by `ops.mlstm`; the library is built
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
    fn = _build.load("mlstm_chunk").mlstm_chunk_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, F, logi, out, scale: float, m=None, n=None) -> None:
    """Enqueue one kernel on the current stream of the tensors' device.
    q/k/v/out [B,H,S,dh]; F (the cumulative log forget gate) and logi
    [B,H,S] float32; m, n: both None, or float32 [B,H,S] that receive each
    row's m and its normaliser n signed by σ where |σ| sets it (what the
    backward needs)."""
    B, H, S, dh = q.shape
    fn = entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), F.data_ptr(), logi.data_ptr(),
            out.data_ptr(), None if m is None else m.data_ptr(),
            None if n is None else n.data_ptr(), B * H, S, dh, scale, DTYPE_CODES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: cudaError {err}")
