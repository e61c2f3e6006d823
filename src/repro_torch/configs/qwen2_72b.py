"""Assigned architecture config: qwen2-72b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("qwen2-72b")
