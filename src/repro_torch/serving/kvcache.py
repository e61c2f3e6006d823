"""Slot-managed KV-cache pool for a serving pod (port of
`repro.serving.kvcache`).

Slots are the serving analogue of the paper's record locks: a request holds
its slots from reservation until release, and the *occupancy window* is the
lock-contention span the GeoTP router minimizes. The pool's cache lives on
the pool's device: the config's own layout, int8 K/V and their scales for
`kv_cache_dtype="int8"`, and for an encoder-decoder the cross K/V of an
empty memory (enc_len = 0), as the reference's pool holds them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SlotPool:
    cfg: ModelConfig
    n_slots: int
    cache_len: int
    device: torch.device = None
    free: list = None
    cache: dict = None  # batched decode cache over all slots

    def __post_init__(self):
        self.free = list(range(self.n_slots))
        self.cache = stack.init_cache(self.cfg, self.n_slots, self.cache_len, self.device)

    def reserve(self, n: int = 1) -> list | None:
        """Acquire n slots ('locks'); None if unavailable."""
        if len(self.free) < n:
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, slots: list) -> None:
        self.free.extend(slots)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self.free) / max(self.n_slots, 1)
