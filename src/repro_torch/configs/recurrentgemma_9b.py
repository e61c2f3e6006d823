"""Assigned architecture config: recurrentgemma-9b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("recurrentgemma-9b")
