"""Assigned architecture config: xlstm-350m (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("xlstm-350m")
