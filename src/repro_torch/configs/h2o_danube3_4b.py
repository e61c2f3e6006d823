"""Assigned architecture config: h2o-danube-3-4b (see registry.py for parameters)."""

from repro_torch.configs.registry import get

CONFIG = get("h2o-danube-3-4b")
