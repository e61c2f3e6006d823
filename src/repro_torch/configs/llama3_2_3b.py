"""Assigned architecture config: llama3.2-3b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("llama3.2-3b")
