"""The decode-attention wrapper: checks, allocates, launches, counts.

On CUDA tensors it launches the hand-written kernel; on CPU tensors it
computes the plain version (`ref.py`). It never catches an error to fall
back. `decode.launches` counts kernel calls (plain calls do not count), so
a run can show that its main path went through the kernel; one call is two
CUDA launches, the split kernel and its merge. `decode.launches_by_cache`
splits them by the cache's dtype: an int8 cache (float32 scales beside it,
`k_scale` / `v_scale`) goes to its own entry point, which dequantizes each
element as it loads it. A cache of no slots (Sc = 0: an encoder-decoder's
cross step over an empty encoder memory) gives zeros, the reference's
value of an empty sum, without a launch: `decode.empty_calls` counts
those. A bf16 q (every model's) takes the kernel's tensor-core route, a
float32 q (the checks) its CUDA-core route, for either cache. `plan` cuts
the cache into splits for the route (`split_plan_mma` / `split_plan`) from
the shapes and the card's SM count alone (the host never reads `valid`),
and `prepare` allocates the float32 partials the merge reads. The kernel takes dh as it is (up to 256) and scales by 1/sqrt(dh)
itself: the reference wrapper's padding of dh to 128 is a TPU matrix-unit
artefact.
`logit_cap` > 0 caps each scaled score at `tanh(s / cap) * cap` before the
mask, as the reference model's attention does (its TPU kernel has no cap).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.decode_attention import decode_attention as _cuda
from repro_torch.kernels.decode_attention.ref import decode_int8_ref, decode_ref

MAX_HEAD_DIM = 256
CHUNK = 32  # cache slots the kernel streams at a time: a split holds whole chunks
MAX_CHUNKS = 256  # chunks a split at most (the kernel lists them in shared memory)
# blocks a split plan aims at for each SM of the card. A block's work is the
# valid chunks of its slot range, which the host cannot see: small splits
# let rows of different lengths spread evenly over the card. chip_smoke.py
# phase 7 times 2 to 12 an SM at llama3.2-3b's and recurrentgemma-9b's
# decode shapes (PERF.md §6). BLOCKS_PER_SM is the CUDA-core route's (a
# float32 q), MMA_BLOCKS_PER_SM the tensor-core route's (a bf16 q): the int8
# and bf16 caches share it, so that the int8 entry stays bit for bit the
# bf16 entry on the dequantized cache; 4 keeps the int8 entry the faster of
# the two at h2o's full ring and llama's linear cache (phase 17) and at
# phase 7's llama shapes (PERF.md §6)
BLOCKS_PER_SM = 6
MMA_BLOCKS_PER_SM = 4


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


def split_plan_mma(B: int, H: int, KV: int, Sc: int, dh: int, sms: int,
                   per_sm: int = MMA_BLOCKS_PER_SM) -> tuple[int, int]:
    """(splits, slots_per_split) of the tensor-core route for a card of `sms`
    SMs: as many splits as keep the blocks (B·KV·row groups of 16 query rows,
    times the splits) within per_sm·sms, one at the least, each a whole number
    of the kernel's rounds
    (two chunks, one at dh > 128, where two warps share a step) and at most
    MAX_CHUNKS chunks; the splits cover [0, Sc) once, the last may be
    ragged."""
    chunks = -(-Sc // CHUNK)
    step = 1 if dh > 128 else 2
    blocks = max(B * KV * -(-(H // max(KV, 1)) // 16), 1)
    splits = max(1, per_sm * sms // blocks)
    per_chunks = -(-chunks // splits)
    per_chunks = min(MAX_CHUNKS, -(-per_chunks // step) * step)
    return -(-chunks // per_chunks), CHUNK * per_chunks


def plan(q, k_cache, per_sm: int | None = None) -> tuple[int, int]:
    """The split plan of q's route on q's device: `split_plan_mma` for a
    bf16 q, `split_plan` for a float32 one; `per_sm` overrides the route's
    blocks an SM."""
    B, H, dh = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    sms = sm_count(q.device)
    if q.dtype == torch.bfloat16:
        return split_plan_mma(B, H, KV, Sc, dh, sms, per_sm or MMA_BLOCKS_PER_SM)
    return split_plan(B, KV, Sc, sms, per_sm or BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k_cache, v_cache, valid, k_scale=None, v_scale=None) -> None:
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
    int8 = k_cache.dtype == torch.int8
    if q.dtype not in _cuda.DTYPE_CODES or (
            {k_cache.dtype, v_cache.dtype} != ({torch.int8} if int8 else {q.dtype})):
        raise TypeError(f"decode: q must be float32 or bfloat16 and the caches q's dtype or "
                        f"both int8; got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    scales = (("k_scale", k_scale), ("v_scale", v_scale))
    if int8:
        for name, x in scales:
            if x is None or x.shape != (B, Sc, KV) or x.dtype != torch.float32:
                raise ValueError(f"decode: an int8 cache needs float32 {name} [B,Sc,KV] = "
                                 f"{(B, Sc, KV)}, got "
                                 f"{None if x is None else (x.dtype, tuple(x.shape))}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("decode: scales go with an int8 cache only")
    named = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("valid", valid))
    for name, x in named + (scales if int8 else ()):
        if x.device != q.device:
            raise ValueError(f"decode: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"decode: {name} must be contiguous")


def prepare(q, k_cache, v_cache, valid, logit_cap: float = 0.0,
            per_sm: int | None = None, k_scale=None, v_scale=None) -> tuple:
    """The kernel's call on checked CUDA inputs (q [B,H,dh], Sc >= 1):
    (out, args), where `_cuda.run(args)` enqueues the split kernel and its
    merge into out (the int8 entry point when `k_scale` is given). Plans
    the split for q's route on the device (`plan`) and allocates out and
    the float32 partials."""
    B, H, dh = q.shape
    splits, per = plan(q, k_cache, per_sm)
    out = torch.empty_like(q)
    scratch = torch.empty(B * H * splits * (dh + 2), dtype=torch.float32, device=q.device)
    if k_scale is not None:
        return out, _cuda.launch_args_int8(q, k_cache, v_cache, k_scale, v_scale, valid, out,
                                           scratch, dh**-0.5, logit_cap, splits, per)
    return out, _cuda.launch_args(q, k_cache, v_cache, valid, out, scratch, dh**-0.5, logit_cap,
                                  splits, per)


def decode(q, k_cache, v_cache, valid, *, logit_cap: float = 0.0, k_scale=None, v_scale=None):
    """q: [B,1,H,dh] or [B,H,dh]; caches [B,Sc,KV,dh] in q's dtype, or int8
    with float32 `k_scale` / `v_scale` [B,Sc,KV]; valid [B,Sc] bool -> q's
    shape and dtype. Sc = 0 gives zeros without a launch."""
    if logit_cap < 0:
        raise ValueError(f"decode: logit_cap must be >= 0, got {logit_cap}")
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    _check(q, k_cache, v_cache, valid, k_scale, v_scale)
    int8 = k_cache.dtype == torch.int8
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode: no kernel for device {q.device}")
    if k_cache.shape[1] == 0:  # an empty memory: the empty sum, on every device
        out = torch.zeros_like(q)
        decode.empty_calls += 1
    elif q.device.type == "cpu":
        if int8:
            out = decode_int8_ref(q, k_cache, v_cache, k_scale, v_scale, valid,
                                  logit_cap=logit_cap)
        else:
            out = decode_ref(q, k_cache, v_cache, valid, logit_cap=logit_cap)
    else:
        _cuda.entry()  # a library that cannot build or load raises before any work
        out, args = prepare(q, k_cache, v_cache, valid, logit_cap, k_scale=k_scale,
                            v_scale=v_scale)
        _cuda.run(args)
        decode.launches += 1
        decode.launches_by_cache["int8" if int8 else str(q.dtype)[6:]] += 1
    return out[:, None] if squeeze else out


def reset_launches() -> None:
    """Zero the launch counts and the count of empty calls."""
    decode.launches = 0
    decode.launches_by_cache = {"float32": 0, "bfloat16": 0, "int8": 0}
    decode.empty_calls = 0


reset_launches()
