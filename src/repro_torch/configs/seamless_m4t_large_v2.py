"""Assigned architecture config: seamless-m4t-large-v2 (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("seamless-m4t-large-v2")
