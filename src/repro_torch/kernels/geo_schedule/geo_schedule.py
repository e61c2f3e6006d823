"""ctypes binding of the CUDA `geo_schedule` kernel (`csrc/geo_schedule.cu`).

`launch` takes tensors already checked by `ops.geo_schedule`; the library is
built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("geo_schedule").geo_schedule_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid, off, p) -> None:
    """Enqueue one kernel on the current stream of the tensors' device.
    `inv`/`valid` are torch bool tensors: one byte each, read as uint8."""
    n, d = tau.shape
    k = c_cnt.shape[1]
    with torch.cuda.device(tau.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            tau.data_ptr(), lel.data_ptr(), inv.data_ptr(),
            c_cnt.data_ptr(), t_cnt.data_ptr(), a_cnt.data_ptr(), valid.data_ptr(),
            off.data_ptr(), p.data_ptr(), n, d, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"geo_schedule kernel launch failed: cudaError {err}")
