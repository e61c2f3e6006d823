"""Legacy re-export shim: the presets live in `repro_torch.core.protocols`.

The counterpart of the reference's `repro.core.protocol`: every name it
exports is re-exported here, so `from repro_torch.core.protocol import
PRESETS, ProtocolConfig, ...` works as the reference's import does.
"""

from __future__ import annotations

from repro_torch.core.protocols import (  # noqa: F401
    CHILLER,
    FASTC,
    GEOTP,
    GEOTP_O1,
    GEOTP_O12,
    OPTA,
    PREPARE_COORD,
    PREPARE_DECENTRAL,
    PREPARE_NONE,
    PRESETS,
    QURO,
    SCALARDB,
    SSP,
    SSP_LOCAL,
    STAGGER_NET,
    STAGGER_NET_LEL,
    STAGGER_NONE,
    TIGA,
    YUGA,
    ProtocolConfig,
    register_preset,
)
