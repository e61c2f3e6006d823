"""The decode-attention wrapper: checks, allocates, launches, counts.

On CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `decode.launches` counts kernel calls (plain calls do not count), so
a run can show that its main path went through the kernel; one call is two
CUDA launches, the split kernel and its merge. `split_plan` cuts the cache
into splits from the shapes and the card's SM count alone (the host never
reads `valid`), and `prepare` allocates the float32 partials the merge
reads. The kernel takes dh as it is (up to 256) and scales by 1/sqrt(dh)
itself: the reference wrapper's padding of dh to 128 is a TPU matrix-unit
artefact.
`logit_cap` > 0 caps each scaled score at `tanh(s / cap) * cap` before the
mask, as the reference model's attention does (its TPU kernel has no cap).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.decode_attention import decode_attention as _cuda
from repro_torch.kernels.decode_attention.ref import decode_ref

MAX_HEAD_DIM = 256
CHUNK = 32  # cache slots the kernel streams at a time: a split holds whole chunks
MAX_CHUNKS = 256  # chunks a split at most (the kernel lists them in shared memory)
# blocks a split plan aims at for each SM of the card. A block's work is the
# valid chunks of its slot range, which the host cannot see: small splits
# let rows of different lengths spread evenly over the card. chip_smoke.py
# phase 7 times 2 to 12 an SM at llama3.2-3b's and recurrentgemma-9b's
# decode shapes (PERF.md §6)
BLOCKS_PER_SM = 6


def split_plan(B: int, KV: int, Sc: int, sms: int,
               per_sm: int = BLOCKS_PER_SM) -> tuple[int, int]:
    """(splits, slots_per_split) for a card of `sms` SMs: whole chunks per
    split, as many splits as give B·KV·splits >= per_sm·sms (one chunk a
    split at the least) and at most MAX_CHUNKS chunks a split; the splits
    cover [0, Sc) once, the last may be ragged. At most 4096 splits (Sc <=
    2**25)."""
    chunks = -(-Sc // CHUNK)
    want = -(-per_sm * sms // max(B * KV, 1))
    per_chunks = min(MAX_CHUNKS, max(1, chunks // want))
    return -(-chunks // per_chunks), CHUNK * per_chunks


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k_cache, v_cache, valid) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"decode: q must be [B,H,dh] and caches [B,Sc,KV,dh], got "
            f"{tuple(q.shape)} and {tuple(k_cache.shape)}"
        )
    B, H, dh = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, Sc, KV, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode: caches must be [B,Sc,KV,dh] = {(B, Sc, KV, dh)}, got "
            f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}"
        )
    if valid.shape != (B, Sc) or valid.dtype != torch.bool:
        raise ValueError(f"decode: valid must be bool [B,Sc] = {(B, Sc)}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"decode: H = {H} must be a multiple of KV = {KV}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _cuda.DTYPE_CODES or {k_cache.dtype, v_cache.dtype} != {q.dtype}:
        raise TypeError(f"decode: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("valid", valid)):
        if x.device != q.device:
            raise ValueError(f"decode: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"decode: {name} must be contiguous")


def prepare(q, k_cache, v_cache, valid, logit_cap: float = 0.0,
            per_sm: int = BLOCKS_PER_SM) -> tuple:
    """The kernel's call on checked CUDA inputs (q [B,H,dh]): (out, args),
    where `_cuda.run(args)` enqueues the split kernel and its merge into
    out. Plans the split for the device (`split_plan`) and allocates out
    and the float32 partials."""
    B, H, dh = q.shape
    splits, per = split_plan(B, k_cache.shape[2], k_cache.shape[1], sm_count(q.device), per_sm)
    out = torch.empty_like(q)
    scratch = torch.empty(B * H * splits * (dh + 2), dtype=torch.float32, device=q.device)
    return out, _cuda.launch_args(q, k_cache, v_cache, valid, out, scratch, dh**-0.5, logit_cap,
                                  splits, per)


def decode(q, k_cache, v_cache, valid, *, logit_cap: float = 0.0):
    """q: [B,1,H,dh] or [B,H,dh]; caches [B,Sc,KV,dh]; valid [B,Sc] bool ->
    q's shape and dtype."""
    if logit_cap < 0:
        raise ValueError(f"decode: logit_cap must be >= 0, got {logit_cap}")
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    _check(q, k_cache, v_cache, valid)
    if q.device.type == "cpu":
        out = decode_ref(q, k_cache, v_cache, valid, logit_cap=logit_cap)
    elif q.device.type == "cuda":
        _cuda.entry()  # a library that cannot build or load raises before any work
        out, args = prepare(q, k_cache, v_cache, valid, logit_cap)
        _cuda.run(args)
        decode.launches += 1
    else:
        raise ValueError(f"decode: no kernel for device {q.device}")
    return out[:, None] if squeeze else out


decode.launches = 0
