"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means ``"cuda"``. A CUDA request without a usable card raises:
    the port never falls back to the CPU on its own — pass ``device="cpu"``
    to run there (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
