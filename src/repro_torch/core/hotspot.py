"""Hotspot footprint (§IV-C): the engine's fixed-capacity hash table.

Port of the hash-table half of `repro.core.hotspot` (`hash_init`,
`probe_slots_batch`, `find_or_claim_slots`, `eq4_masked_w`,
`lookup_slots`), written over a leading batch axis: a table is [B, C+1]
(the last row is a scratch slot), a footprint is [B, K]. The dense
record-indexed table waits for a later slice.

Four fields per slot, as the paper's §IV-C: w_lat (Eq.4 EWMA of the
latency share, int32 µs), t_cnt / c_cnt (finished / committed accesses) and
a_cnt (in-flight accesses), plus a clock (second-chance) bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.netmodel import U32, _hash_u32, f32, fma_f32

EMPTY = -1


class HashHotspot(NamedTuple):
    slot_key: torch.Tensor  # [..., C] int32, -1 = empty
    w_lat: torch.Tensor  # [..., C] int32
    t_cnt: torch.Tensor  # [..., C] int32
    c_cnt: torch.Tensor  # [..., C] int32
    a_cnt: torch.Tensor  # [..., C] int32
    clock: torch.Tensor  # [..., C] int8 second-chance bit


def hash_init(capacity: int) -> HashHotspot:
    z = lambda dt: torch.zeros((capacity,), dtype=dt)
    return HashHotspot(
        slot_key=torch.full((capacity,), EMPTY, dtype=torch.int32),
        w_lat=z(torch.int32),
        t_cnt=z(torch.int32),
        c_cnt=z(torch.int32),
        a_cnt=z(torch.int32),
        clock=z(torch.int8),
    )


def probe_slots_batch(keys: torch.Tensor, capacity: int, probes: int = 8) -> torch.Tensor:
    """[..., K] int32 keys -> [..., K, P] int64 probe slots:
    (h(k) + i*step(k)) mod 2**32 mod C, step odd."""
    h = _hash_u32(keys)
    step = _hash_u32(keys.to(torch.int64) + 0x9E3779B9) | 1
    i = torch.arange(probes, dtype=torch.int64, device=keys.device)
    return ((h[..., None] + i * step[..., None]) & U32) % capacity


def _row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, C], idx [B, ...] -> table[b, idx[b, ...]]."""
    B = table.shape[0]
    return torch.gather(table, 1, idx.reshape(B, -1)).reshape(idx.shape)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return mask.to(torch.int32).argmax(dim=-1)


def find_or_claim_slots(slot_key, keys, valid, probes: int = 8):
    """Batched find-or-insert. slot_key [B, C+1]; keys/valid [B, K].

    Returns (slots [B, K] int64 — C (scratch) for invalid entries, evict
    [B, K] bool — the slot held a different key and its stats reset)."""
    capacity = slot_key.shape[-1] - 1
    pr = probe_slots_batch(keys, capacity, probes)  # [B,K,P]
    at = _row_gather(slot_key, pr)
    match = at == keys[..., None]
    empty = at == EMPTY
    has_match = match.any(-1)
    has_empty = empty.any(-1)
    first_match = pr.gather(-1, _first_true(match)[..., None])[..., 0]
    first_empty = pr.gather(-1, _first_true(empty)[..., None])[..., 0]
    victim = pr[..., 0]
    slot = torch.where(has_match, first_match, torch.where(has_empty, first_empty, victim))
    slot = torch.where(valid, slot, capacity)
    evict = valid & ~has_match
    return slot, evict


def lookup_slots(slot_key, keys, valid, probes: int = 8):
    """Batched read-only lookup: [B, K] keys -> ([B, K] slots, [B, K] found).
    Misses map to the scratch row (index C)."""
    capacity = slot_key.shape[-1] - 1
    pr = probe_slots_batch(keys, capacity, probes)
    at = _row_gather(slot_key, pr)
    match = at == keys[..., None]
    found = match.any(-1) & valid
    hit = pr.gather(-1, _first_true(match)[..., None])[..., 0]
    return torch.where(found, hit, capacity), found


def last_writer_values(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """For a scatter-set of `vals` [B, K] at `idx` [B, K]: each entry's value
    replaced by the value of the LAST entry (largest k) with the same index,
    so a scatter of the result is order-free. Pins the documented race of
    two keys claiming one empty slot to last-wins, the order XLA:CPU
    applies scatter updates in (held by the tests)."""
    K = idx.shape[-1]
    same = idx[..., :, None] == idx[..., None, :]  # [B,K,K]
    ks = torch.arange(K, device=idx.device)
    winner = torch.where(same, ks, -1).amax(-1)
    return vals.gather(-1, winner)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order 0..K-1 (a fixed float order,
    the same on every device)."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def eq4_masked_w(w_lat, slot, found, lel, alpha_milli: int) -> torch.Tensor:
    """Eq.(4) share/EWMA/clip over one footprint (trailing axis).

    w_lat [B, C+1] int32; slot/found [B, K]; lel float32 broadcastable
    against [B, 1]. Returns the updated w_lat values [B, K] int32."""
    vf = found.to(torch.float32)
    w_old = _row_gather(w_lat, slot).to(torch.float32) * vf
    total = sum_last(w_old)[..., None]
    n = torch.clamp_min(sum_last(vf)[..., None], 1.0)
    share = torch.where(total > 0.0, w_old / torch.clamp_min(total, 1.0), vf / n)
    a = f32(alpha_milli / 1000.0)
    oma = f32(1.0 - a)
    if a == oma:
        # alpha = 0.5: XLA factors w*a + (lel*share)*a into
        # fma(lel, share, w) * a — reproduce that rounding
        new = fma_f32(lel.expand_as(share), share, w_old) * a
    else:
        new = fma_f32(w_old, a, lel * share * oma)
    return torch.clamp(new, 0.0, 1e7).to(torch.int32)
