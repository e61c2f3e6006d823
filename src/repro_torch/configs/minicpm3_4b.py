"""Assigned architecture config: minicpm3-4b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("minicpm3-4b")
