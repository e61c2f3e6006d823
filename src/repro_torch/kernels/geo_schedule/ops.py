"""The `geo_schedule` wrapper: checks, allocates, launches, counts.

On CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `geo_schedule.launches` counts kernel launches (plain calls do not
count), so a run can show that its main path went through the kernel.

The wrapper launches alike whether or not the current stream is being
captured into a CUDA graph (the engine's step, `engine.batch`): outputs
from `torch.empty` (in the graph's pool during a capture), the launch on
`torch.cuda.current_stream()`, no host synchronisation, and the launch's
`cudaGetLastError` checked. A launch recorded in a capture is counted
once here; the engine's runner counts its replays.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.geo_schedule import geo_schedule as _cuda
from repro_torch.kernels.geo_schedule.ref import geo_schedule_ref

_KINDS = (
    ("tau", torch.int32, "D"),
    ("lel", torch.int32, "D"),
    ("inv", torch.bool, "D"),
    ("c_cnt", torch.int32, "K"),
    ("t_cnt", torch.int32, "K"),
    ("a_cnt", torch.int32, "K"),
    ("valid", torch.bool, "K"),
)


def _check(args) -> None:
    n = args[0].shape[0] if args[0].dim() == 2 else None
    widths = {"D": args[0].shape[-1], "K": args[3].shape[-1]}
    dev = args[0].device
    for (name, dtype, w), x in zip(_KINDS, args):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"geo_schedule: {name} must be a tensor")
        if x.dtype != dtype:
            raise TypeError(f"geo_schedule: {name} must be {dtype}, got {x.dtype}")
        if x.dim() != 2 or x.shape != (n, widths[w]):
            raise ValueError(
                f"geo_schedule: {name} must be [N, {w}] = {(n, widths[w])}, got {tuple(x.shape)}"
            )
        if x.device != dev:
            raise ValueError(f"geo_schedule: {name} on {x.device}, tau on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"geo_schedule: {name} must be contiguous")
    if widths["D"] < 1 or widths["K"] < 1:
        raise ValueError("geo_schedule: D and K must be >= 1")


def geo_schedule(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid):
    """Batched Eq.(8) offsets + Eq.(9) abort probabilities for N rows.

    tau/lel [N,D] int32 µs, inv [N,D] bool, c/t/a_cnt [N,K] int32,
    valid [N,K] bool -> (offsets [N,D] int32, p_abort [N] float32)."""
    args = (tau, lel, inv, c_cnt, t_cnt, a_cnt, valid)
    _check(args)
    if tau.device.type == "cpu":
        return geo_schedule_ref(*args)
    if tau.device.type != "cuda":
        raise ValueError(f"geo_schedule: no kernel for device {tau.device}")
    off = torch.empty(tau.shape, dtype=torch.int32, device=tau.device)
    p = torch.empty((tau.shape[0],), dtype=torch.float32, device=tau.device)
    _cuda.launch(*args, off, p)
    geo_schedule.launches += 1
    return off, p


geo_schedule.launches = 0


def schedule_batch(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid, *, bn: int = 256):
    """The reference's public name for the batched scheduler op
    (`repro.kernels.geo_schedule.ops.schedule_batch`): `geo_schedule`.

    `bn` is accepted and ignored: it is the Pallas kernel's row-block size
    on the TPU, while the CUDA kernel sizes its own launch. There is no
    `interpret`: nothing in the port runs interpreted (the plain version
    runs on CPU tensors)."""
    return geo_schedule(tau, lel, inv, c_cnt, t_cnt, a_cnt, valid)
