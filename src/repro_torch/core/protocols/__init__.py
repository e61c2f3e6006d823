"""Protocol zoo: commit-protocol presets, mode constants, and the registry.

Public surface:
  - `ProtocolConfig` + the STAGGER_*/PREPARE_* mode constants (`base`)
  - `PRESETS` (frozen name -> ProtocolConfig view) and `register_preset`
    (`registry`)
  - the built-in preset instances (`presets`) — importing this package
    registers them

This is the port's own copy of the reference preset registry (the port
imports nothing of the JAX package); `tests/test_torch_workloads.py` holds
the two registries equal field by field.
"""

from repro_torch.core.protocols.base import (
    PREPARE_COORD,
    PREPARE_DECENTRAL,
    PREPARE_NONE,
    STAGGER_NET,
    STAGGER_NET_LEL,
    STAGGER_NONE,
    ProtocolConfig,
)
from repro_torch.core.protocols.presets import (
    CHILLER,
    FASTC,
    GEOTP,
    GEOTP_O1,
    GEOTP_O12,
    OPTA,
    QURO,
    SCALARDB,
    SSP,
    SSP_LOCAL,
    TIGA,
    YUGA,
)
from repro_torch.core.protocols.registry import PRESETS, register_preset

__all__ = [
    "PREPARE_COORD",
    "PREPARE_DECENTRAL",
    "PREPARE_NONE",
    "STAGGER_NET",
    "STAGGER_NET_LEL",
    "STAGGER_NONE",
    "ProtocolConfig",
    "PRESETS",
    "register_preset",
    "SSP",
    "SSP_LOCAL",
    "SCALARDB",
    "QURO",
    "CHILLER",
    "YUGA",
    "GEOTP_O1",
    "GEOTP_O12",
    "GEOTP",
    "FASTC",
    "TIGA",
    "OPTA",
]
