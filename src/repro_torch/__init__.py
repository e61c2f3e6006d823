"""GeoTP on PyTorch + CUDA: the H100 port of the `repro` discrete-event engine.

Module paths mirror `src/repro/` (`repro_torch.core.netmodel` is the
counterpart of `repro.core.netmodel`, and so on). The port imports `torch`
and `numpy` only: never `jax`, never any module of `repro`.

What this package runs today is the lockstep, fault-free step of the engine
(`core/engine/omni.py::_omni_step` over a leading [B] lane axis) behind
`Simulator.run_grid`, with Eq.(8)/Eq.(9) in the hand-written CUDA
`geo_schedule` kernel. Entry points run on the card unless the caller asks
for the CPU (`device="cpu"`); with no card they raise.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
