"""Assigned architecture config: internvl2-26b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("internvl2-26b")
