"""GeoTP on PyTorch + CUDA: the H100 port of the `repro` package.

Module paths mirror `src/repro/` (`repro_torch.core.netmodel` is the
counterpart of `repro.core.netmodel`, and so on). The port imports `torch`
and `numpy` only: never `jax`, never any module of `repro`.

Layers, as the reference's:
  repro_torch.core     — the paper's scheduler and hotspot math, the protocol
                         presets and the discrete-event engine: every step
                         mode (lockstep lanes captured into a CUDA graph,
                         sequential lanes), fault schedules, continuation and
                         the placement table (map / vmap / mesh) behind
                         `Simulator.run_grid`;
  repro_torch.models   — the LM stack of the ten registry architectures and
                         the analytic FLOPs model;
  repro_torch.dist     — sharding rules and the worlds mesh's placement,
                         one-round-commit checkpoints, elastic resizing,
                         gradient compression;
  repro_torch.serving  — the geo-serving router and its KV cache;
  repro_torch.kernels  — hand-written CUDA kernels for the five Pallas
                         kernels (and three backwards), each beside its plain
                         version;
  repro_torch.launch   — meshes and the train / serve launchers;
  repro_torch.bench    — the harness, the smoke, the paper's figures and
                         claims.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); with no card they raise.
"""

from repro_torch.device import resolve_device

__version__ = "1.0.0"

__all__ = ["resolve_device"]
