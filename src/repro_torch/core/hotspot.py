"""Hotspot footprint (§IV-C): the engine's fixed-capacity hash table, and
the dense record-indexed table.

Port of `repro.core.hotspot`. The engine's half (`hash_init`,
`probe_slots_batch`, `find_or_claim_slots`, `eq4_masked_w`,
`lookup_slots`) is written over a leading batch axis: a table is [B, C+1]
(the last row is a scratch slot), a footprint is [B, K]. The leaves no
engine step calls are the reference's single-table functions: the dense
table (`DenseHotspot`, `dense_*`, indexed by record id) and the scalar
`hash_lookup` / `hash_touch` with clock eviction.

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


# ---------------------------------------------------------------------------
# the leaves no engine step calls: the dense table and the scalar hash ops
# ---------------------------------------------------------------------------


class DenseHotspot(NamedTuple):
    w_lat: torch.Tensor  # [R] int32 µs
    t_cnt: torch.Tensor  # [R] int32
    c_cnt: torch.Tensor  # [R] int32
    a_cnt: torch.Tensor  # [R] int32


def dense_init(num_records: int) -> DenseHotspot:
    z = torch.zeros((num_records,), dtype=torch.int32)
    return DenseHotspot(w_lat=z, t_cnt=z.clone(), c_cnt=z.clone(), a_cnt=z.clone())


def _safe(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, keys.to(torch.int64), 0)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with the reference's gather rule: negative indices wrap once,
    then out-of-range indices clamp."""
    n = x.shape[0]
    return x[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def _scatter_add(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x.at[idx].add(v, mode="drop"): indices outside [-n, n) are dropped."""
    n = x.shape[0]
    keep = (idx >= -n) & (idx < n)
    idx = torch.where(idx < 0, idx + n, idx)
    return x.index_add(0, idx[keep], v.to(x.dtype)[keep])


def _scatter_set(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x.at[idx].set(v, mode="drop"), duplicates last-wins (XLA:CPU's order)."""
    n = x.shape[0]
    keep = (idx >= -n) & (idx < n)
    idx = torch.where(idx < 0, idx + n, idx)
    v = last_writer_values(idx[None], v.to(x.dtype)[None])[0]
    out = x.clone()
    out[idx[keep]] = v[keep]
    return out


def dense_on_dispatch(hs: DenseHotspot, keys, valid) -> DenseHotspot:
    """A transaction starts accessing `keys` (a_cnt + 1). t_cnt counts
    finished accesses, so c_cnt / t_cnt in Eq.(9) is the historical commit
    ratio, not biased down by in-flight transactions."""
    return hs._replace(a_cnt=_scatter_add(hs.a_cnt, _safe(keys, valid), valid.to(torch.int32)))


def dense_on_complete(hs: DenseHotspot, keys, valid, committed, lel_us, alpha_milli) -> DenseHotspot:
    """A subtransaction finished (committed or aborted): the Eq.(4) EWMA and
    the counters. keys / valid [K]; committed a scalar bool; lel_us the
    measured local execution latency (int32 µs); alpha_milli α in 1/1000.
    w_r = w_lat_r / Σ w_lat (uniform if the sum is 0), then w_lat_r <- α
    w_lat_r + (1 - α) LEL w_r in float32, rounded back to int32 µs and
    capped at 10 s."""
    safe = _safe(keys, valid)
    vf = valid.to(torch.float32)
    old = _gather(hs.w_lat, safe).to(torch.float32)
    w = old * vf
    total = w.sum()
    n = torch.clamp_min(vf.sum(), 1.0)
    share = torch.where(total > 0.0, w / torch.clamp_min(total, 1.0), vf / n)
    lel_share = torch.as_tensor(lel_us).to(torch.float32) * share
    a = torch.as_tensor(alpha_milli).to(torch.float32) / 1000.0
    new = old * a + lel_share * (1.0 - a)
    new = torch.clamp(torch.where(valid, new, old), 0.0, 1e7).to(torch.int32)
    dec = valid.to(torch.int32)
    return hs._replace(
        w_lat=_scatter_set(hs.w_lat, safe, new),
        a_cnt=torch.clamp_min(_scatter_add(hs.a_cnt, safe, -dec), 0),
        t_cnt=_scatter_add(hs.t_cnt, safe, dec),
        c_cnt=_scatter_add(hs.c_cnt, safe, dec * torch.as_tensor(committed).to(torch.int32)),
    )


def dense_forecast_lel(hs: DenseHotspot, keys, valid) -> torch.Tensor:
    """Eq.(5): LEL^ = Σ_r w_lat_r over one subtransaction's records.
    keys / valid [..., K]; returns [...] int32 µs."""
    w = _gather(hs.w_lat, _safe(keys, valid)) * valid.to(torch.int32)
    return w.sum(-1, dtype=torch.int32)


def dense_gather_stats(hs: DenseHotspot, keys, valid):
    """(c_cnt, t_cnt, a_cnt) for Eq.(9); invalid slots read record 0."""
    safe = _safe(keys, valid)
    return _gather(hs.c_cnt, safe), _gather(hs.t_cnt, safe), _gather(hs.a_cnt, safe)


def _probe_slots(key: torch.Tensor, capacity: int, probes: int) -> torch.Tensor:
    """One key's probe sequence: (h(k) + i*step) mod C, step odd. The
    step hashes key + 0x9E3779B9 mod 2**32, as `probe_slots_batch` does
    (the reference's scalar form overflows its int32 add: ROADMAP §C, C9)."""
    return probe_slots_batch(torch.as_tensor(key, dtype=torch.int32)[None], capacity, probes)[0]


def hash_lookup(hs: HashHotspot, key, probes: int = 8):
    """Returns (slot, found): the slot holding `key`, or -1."""
    slots = _probe_slots(key, hs.slot_key.shape[0], probes)
    match = hs.slot_key[slots] == key
    found = match.any()
    slot = torch.where(found, slots[_first_true(match)], -1)
    return slot.to(torch.int32), found


def hash_touch(hs: HashHotspot, key, probes: int = 8):
    """Find-or-insert `key`; evicts by clock second chance within the probe
    window when it is full. Returns (hs, slot)."""
    slots = _probe_slots(key, hs.slot_key.shape[0], probes)
    keys_at = hs.slot_key[slots]
    match = keys_at == key
    empty = keys_at == EMPTY
    cold = hs.clock[slots] == 0
    # victim: the first clock == 0 slot of the window, else its first slot
    victim = torch.where(cold.any(), slots[_first_true(cold)], slots[0])
    slot = torch.where(match.any(), slots[_first_true(match)],
                       torch.where(empty.any(), slots[_first_true(empty)], victim))
    fresh = ~match.any()
    keep = lambda x: torch.where(fresh, 0, x[slot]).to(x.dtype)  # noqa: E731
    put = lambda x, v: x.index_put((slot[None],), torch.as_tensor(v, dtype=x.dtype)[None])  # noqa: E731
    hs = hs._replace(
        slot_key=put(hs.slot_key, key), w_lat=put(hs.w_lat, keep(hs.w_lat)),
        t_cnt=put(hs.t_cnt, keep(hs.t_cnt)), c_cnt=put(hs.c_cnt, keep(hs.c_cnt)),
        a_cnt=put(hs.a_cnt, keep(hs.a_cnt)), clock=put(hs.clock, 1),
    )
    # age the rest of the probe window (an approximate clock hand)
    age = (slots == slot).to(torch.int8)
    clock = hs.clock.clone()
    clock.scatter_reduce_(0, slots, age, reduce="amin")
    return hs._replace(clock=clock), slot.to(torch.int32)
