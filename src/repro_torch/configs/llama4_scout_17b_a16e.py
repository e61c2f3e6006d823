"""Assigned architecture config: llama4-scout-17b-a16e (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("llama4-scout-17b-a16e")
