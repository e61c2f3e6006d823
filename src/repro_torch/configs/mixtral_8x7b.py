"""Assigned architecture config: mixtral-8x7b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("mixtral-8x7b")
