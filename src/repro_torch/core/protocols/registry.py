"""Frozen preset registry + the `register_preset` extension API.

`PRESETS` is a read-only view (MappingProxyType) of the registry: imports can
look presets up but cannot clobber the table. All mutation goes through
`register_preset`, which rejects duplicate names loudly — re-registering a
name would silently change what every existing Grid cell means.
"""

from __future__ import annotations

from types import MappingProxyType

from repro_torch.core.protocols.base import ProtocolConfig

_REGISTRY: dict[str, ProtocolConfig] = {}

#: Read-only live view of the registry — safe to iterate/lookup, raises
#: TypeError on item assignment. Register new presets via `register_preset`.
PRESETS = MappingProxyType(_REGISTRY)


def register_preset(proto: ProtocolConfig, *, replace: bool = False) -> ProtocolConfig:
    """Add a preset to the registry under ``proto.name``; returns it.

    Duplicate names raise (a silent overwrite would redefine existing Grid
    cells); pass ``replace=True`` only to intentionally shadow a preset, e.g.
    re-tuning a timing knob for one experiment.
    """
    if not isinstance(proto, ProtocolConfig):
        raise TypeError(f"register_preset needs a ProtocolConfig, got {type(proto).__name__}")
    if not proto.name:
        raise ValueError("preset name must be non-empty")
    if proto.name in _REGISTRY and not replace:
        raise ValueError(
            f"preset {proto.name!r} is already registered "
            f"(pass replace=True to intentionally shadow it)"
        )
    _REGISTRY[proto.name] = proto
    return proto
