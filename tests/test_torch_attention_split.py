"""The redesigned attention kernels' host-side rules, on the CPU: the decode
kernel's cache split (`ops.split_plan`) and the arithmetic of its split and
merge, written out here in PyTorch as the CUDA kernels compute it and held
against the plain version (float32, 2e-5: the two differ only by summation
order); and `chip_smoke.check_rows`, the per-row check that holds the bf16
kernels on the card, against the faults it must see and the rounding it
must let through."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.flash_attention.ref import attention_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

H100_SMS = 132  # the SMs of an H100 SXM
SERVING_DECODES = {  # (B, KV, Sc): llama3.2-3b, recurrentgemma-9b, the router
    "llama": (8, 8, 4096), "recurrentgemma": (4, 1, 2048), "router": (1, 8, 64)}


@pytest.mark.parametrize("B,KV,Sc", [(1, 1, 1), (1, 8, 64), (2, 2, 33), (8, 8, 4001),
                                     (3, 5, 1000), (4, 1, 2048), (8, 8, 4096), (64, 8, 4096),
                                     (1, 1, 100_000), (512, 8, 32768)])
def test_split_plan_covers_every_slot_once(B, KV, Sc):
    splits, per = dec_ops.split_plan(B, KV, Sc, H100_SMS)
    assert per % dec_ops.CHUNK == 0 and 0 < per <= dec_ops.CHUNK * dec_ops.MAX_CHUNKS
    cover = torch.zeros(Sc, dtype=torch.int64)
    for sp in range(splits):
        cover[sp * per: min(Sc, (sp + 1) * per)] += 1
    assert bool((cover == 1).all()) and (splits - 1) * per < Sc  # no empty split
    chunks = -(-Sc // dec_ops.CHUNK)
    assert B * KV * splits >= min(dec_ops.BLOCKS_PER_SM * H100_SMS, B * KV * chunks)


@pytest.mark.parametrize("name", sorted(SERVING_DECODES))
def test_split_plan_fills_the_card_at_the_serving_shapes(name):
    B, KV, Sc = SERVING_DECODES[name]
    splits, per = dec_ops.split_plan(B, KV, Sc, H100_SMS)
    blocks, most = B * KV * splits, B * KV * Sc // dec_ops.CHUNK
    assert blocks >= 264 if most >= 264 else blocks == most  # two blocks an SM, where possible
    assert {"llama": (15, 288), "recurrentgemma": (64, 32), "router": (2, 32)}[name] == (splits, per)


@pytest.mark.parametrize("sms", [1, 66, 132, 264])
def test_split_plan_follows_the_sm_count(sms):
    B, KV, Sc = SERVING_DECODES["llama"]
    for per_sm in (2, 6, 12):
        splits, per = dec_ops.split_plan(B, KV, Sc, sms, per_sm)
        assert B * KV * splits >= min(per_sm * sms, B * KV * Sc // dec_ops.CHUNK)
        assert splits == 1 or B * KV * (splits - 1) < 2 * per_sm * sms  # no more than it aims at


@pytest.mark.parametrize("B,H,KV,Sc,dh", [(1, 1, 1, 1, 64), (1, 24, 8, 64, 128),
                                         (2, 6, 2, 33, 34), (8, 32, 8, 4096, 120),
                                         (8, 24, 8, 4001, 128), (4, 16, 1, 2048, 256),
                                         (2, 40, 2, 700, 64), (3, 6, 2, 1000, 34),
                                         (64, 32, 8, 4096, 128), (1, 8, 1, 100_000, 256)])
def test_mma_split_plan_covers_every_slot_once(B, H, KV, Sc, dh):
    """The tensor-core route's plan: whole rounds a split (two chunks, one at
    dh > 128) but where MAX_CHUNKS caps it, every slot in one split, no
    empty split, and no more blocks than one wave of MMA_BLOCKS_PER_SM an SM
    (or one split a row group where the rows alone are more)."""
    splits, per = dec_ops.split_plan_mma(B, H, KV, Sc, dh, H100_SMS)
    step = 1 if dh > 128 else 2
    assert per % (dec_ops.CHUNK * step) == 0 and 0 < per <= dec_ops.CHUNK * dec_ops.MAX_CHUNKS
    cover = torch.zeros(Sc, dtype=torch.int64)
    for sp in range(splits):
        cover[sp * per: min(Sc, (sp + 1) * per)] += 1
    assert bool((cover == 1).all()) and (splits - 1) * per < Sc
    blocks = B * KV * -(-(H // KV) // 16)
    assert blocks * splits <= max(dec_ops.MMA_BLOCKS_PER_SM * H100_SMS, blocks)


def test_plan_takes_the_route_of_q(monkeypatch):
    """A bf16 q plans for the tensor-core route, a float32 q for the
    CUDA-core one; `per_sm` overrides either's blocks an SM."""
    monkeypatch.setattr(dec_ops, "sm_count", lambda device: H100_SMS)
    B, Sc, H, KV, dh = 8, 4096, 32, 8, 120
    k = torch.zeros((B, Sc, KV, dh), dtype=torch.int8)
    q = torch.zeros((B, H, dh))
    assert dec_ops.plan(q.bfloat16(), k) == dec_ops.split_plan_mma(B, H, KV, Sc, dh, H100_SMS)
    assert dec_ops.plan(q, k) == dec_ops.split_plan(B, KV, Sc, H100_SMS)
    assert dec_ops.plan(q.bfloat16(), k, per_sm=1) == \
        dec_ops.split_plan_mma(B, H, KV, Sc, dh, H100_SMS, 1)
    assert dec_ops.plan(q, k, per_sm=2) == dec_ops.split_plan(B, KV, Sc, H100_SMS, 2)


def split_merge(q, k, v, valid, logit_cap=0.0):
    """The CUDA decode kernel's arithmetic: per (b, kv head, split) block an
    online softmax over chunks of 32 slots that skips a chunk with no valid
    slot when its row has one elsewhere, float32 partials (m, l, acc), then
    the merge in split order. q [B,H,dh], caches [B,Sc,KV,dh] -> [B,H,dh]."""
    B, H, dh = q.shape
    Sc, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum("bngd,bsnd->bngs", q.reshape(B, KV, G, dh).float(), k.float()) * dh**-0.5
    if logit_cap > 0:
        s = torch.tanh(s / logit_cap) * logit_cap
    x = torch.where(valid[:, None, None, :], s, -1e30)
    vf = v.float()
    row_any = valid.any(1)[:, None, None]  # [B,1,1]
    splits, per = dec_ops.split_plan(B, KV, Sc, H100_SMS)
    parts, skipped = [], 0
    for sp in range(splits):
        lo, hi = sp * per, min(Sc, (sp + 1) * per)
        m = torch.full((B, KV, G), -1e30)
        l, acc = torch.zeros((B, KV, G)), torch.zeros((B, KV, G, dh))
        for c0 in range(lo, hi, dec_ops.CHUNK):
            c1 = min(c0 + dec_ops.CHUNK, hi)  # slots past the split's end: no term
            need = valid[:, c0:c1].any(1)[:, None, None] | ~row_any
            skipped += int((~need).sum())
            xs = x[..., c0:c1]
            m_new = torch.maximum(m, xs.max(-1).values)
            alpha, p = torch.exp(m - m_new), torch.exp(xs - m_new[..., None])
            l_new = l * alpha + p.sum(-1)
            acc_new = acc * alpha[..., None] + torch.einsum("bngs,bsnd->bngd", p, vf[:, c0:c1])
            m, l = torch.where(need, m_new, m), torch.where(need, l_new, l)
            acc = torch.where(need[..., None], acc_new, acc)
        parts.append((m, l, acc))
    mm = torch.stack([p[0] for p in parts]).max(0).values
    ll, aa = torch.zeros_like(mm), torch.zeros((B, KV, G, dh))
    for m, l, acc in parts:
        w = torch.exp(m - mm)
        ll, aa = ll + l * w, aa + acc * w[..., None]
    out = aa / torch.clamp(ll, min=1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype), skipped


def _decode_inputs(B, Sc, H, KV, dh, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32) * scale)
    k, v = (torch.from_numpy(rng.standard_normal((B, Sc, KV, dh), np.float32)) for _ in "kv")
    pos = torch.from_numpy(rng.integers(1, Sc, B))
    return q, k, v, torch.arange(Sc)[None, :] <= pos[:, None]


@pytest.mark.parametrize("case", ["leading_splits_invalid", "row_without_valid_slot",
                                  "ragged_last_split", "cap_50"])
def test_split_and_merge_is_the_plain_version(case):
    B, Sc, H, KV, dh = 3, 300, 6, 2, 16
    cap = 0.0
    if case == "ragged_last_split":
        Sc = 301
    q, k, v, valid = _decode_inputs(B, Sc, H, KV, dh, seed=5,
                                    scale=chip_smoke.SOFTCAP_INPUT_SCALE if case == "cap_50" else 1)
    if case == "leading_splits_invalid":
        valid = (torch.arange(Sc) >= 250)[None].expand(B, Sc).contiguous()
    elif case == "row_without_valid_slot":
        valid[1] = False
    elif case == "cap_50":
        cap = 50.0
    splits, per = dec_ops.split_plan(B, KV, Sc, H100_SMS)
    assert splits > 1
    if case == "ragged_last_split":
        assert Sc % per != 0
    out, skipped = split_merge(q, k, v, valid, logit_cap=cap)
    ref = decode_ref(q, k, v, valid, logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
    if case == "leading_splits_invalid":
        assert skipped > 0  # whole splits of invalid slots add nothing
    if case == "row_without_valid_slot":  # the TPU kernel's mean of v
        mean_v = v[1].mean(0).repeat_interleave(H // KV, dim=0)
        np.testing.assert_allclose(out[1].numpy(), mean_v.numpy(), atol=1e-5)


def _flash_bf16(S, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).bfloat16()
            for s in ((1, H, S, dh), (1, KV, S, dh), (1, KV, S, dh))]


def _attention(q, k, v, *, drop=None, p_bf16=False):
    """Causal attention in float32, q [B,H,S,dh], k/v [B,KV,S,dh]; `drop`:
    (query rows, keys) masked, a tile a faulty kernel skips;
    `p_bf16`: P and the output rounded to bf16, as the reference model
    rounds them (the tensor-core kernel keeps P as a bf16 pair, closer)."""
    S, dh = q.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    kf, vf = (torch.repeat_interleave(x.float(), G, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * dh**-0.5
    mask = torch.ones((S, S), dtype=torch.bool).tril()
    if drop is not None:
        mask[drop] = False
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    if p_bf16:
        p = p.bfloat16().float()
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def test_row_check_sees_a_dropped_key_tile():
    q, k, v = _flash_bf16(2048, 2, 1, 128, seed=0)
    ref = attention_ref(q, k, v, causal=True)
    out = _attention(q, k, v, drop=(slice(1920, None), slice(0, 64)))  # the last query block
    rel = (out.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)
    assert float(rel[..., 1920:].min()) > 0.07  # every row of the block moves by 7% or more
    with pytest.raises(AssertionError, match="rows differ"):
        chip_smoke.check_rows(out, ref, "dropped tile")


def test_row_check_lets_bf16_rounding_through():
    q, k, v = _flash_bf16(2048, 2, 1, 128, seed=1)
    ref = attention_ref(q, k, v, causal=True)
    worst = chip_smoke.check_rows(_attention(q, k, v, p_bf16=True), ref, "bf16 P and output")
    assert 0 < worst < chip_smoke.ROW_RTOL / 2


def test_row_check_rejects_non_finite_rows():
    ref = torch.ones((2, 3, 8))
    out = ref.clone()
    out[1, 2, 0] = float("nan")
    with pytest.raises(AssertionError, match="1 rows differ"):
        chip_smoke.check_rows(out, ref, "nan")
