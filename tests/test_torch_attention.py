"""The attention kernels' plain versions and the attention mixers of the port
against the reference.

Tolerances: the plain versions compute in float32 like the reference's
kernels and oracles, so they are held at the reference kernel tests' `TOL`
(2e-5 float32, 2e-2 bfloat16, atol = rtol). The model-level contract
functions are held at 2e-2: the reference rounds its scores and
probabilities to bfloat16 around the softmax, the port's kernels do not.
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.decode_attention.ops import decode as r_decode
from repro.kernels.decode_attention.ref import decode_ref as r_decode_ref
from repro.kernels.flash_attention.ops import mha as r_mha
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro.models import attention as r_attn
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention as t_dec_bind
from repro_torch.kernels.decode_attention import ops as t_dec
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.flash_attention import flash_attention as t_flash_bind
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as t_attn

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/kernels/test_kernels.py
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference kernel tests' cases (tests/kernels/test_kernels.py)
FLASH_CASES = [
    # (B, S, H, KV, dh, causal, window, chunk_local)
    (2, 256, 4, 2, 64, True, 0, False),
    (1, 512, 4, 4, 128, True, 128, False),
    (2, 256, 8, 2, 120, True, 64, True),  # unaligned head_dim (danube)
    (1, 128, 2, 1, 64, False, 0, False),  # MQA encoder (non-causal)
    (1, 384, 6, 6, 32, True, 96, False),  # odd block/sequence ratios
]
DECODE_CASES = [
    (2, 1024, 8, 2, 64),
    (4, 512, 4, 4, 128),
    (1, 2048, 16, 1, 120),  # MQA, unaligned head dim (recurrentgemma)
    (3, 768, 6, 3, 64),  # non-pow2 everything
]


def _both(x, dtype):
    """One numpy array as a reference array and a port tensor of `dtype`
    (both round float32 to bfloat16 to nearest-even: the same bits)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(out, ref, tol):
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )


def test_cases_are_the_reference_kernel_tests():
    spec = importlib.util.spec_from_file_location(
        "_ref_kernel_tests", ROOT / "tests" / "kernels" / "test_kernels.py"
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert FLASH_CASES == ref.FLASH_CASES == chip_smoke.FLASH_CASES
    assert DECODE_CASES == ref.DECODE_CASES == chip_smoke.DECODE_CASES
    assert {jnp.dtype(k).name: v for k, v in ref.TOL.items()} == TOL == chip_smoke.TOL


@pytest.mark.parametrize("case", FLASH_CASES + chip_smoke.WIDE_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_matches_reference(case, dtype):
    B, S, H, KV, dh, causal, window, cl = case
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh))
    )
    launches = t_flash.mha.launches
    out = t_flash.mha(q, k, v, causal=causal, window=window, chunk_local=cl)
    assert t_flash.mha.launches == launches  # CPU tensors: the plain version, no launch
    assert out.shape == (B, S, H, dh) and out.dtype == q.dtype
    kw = dict(causal=causal, window=window, chunk_local=cl)
    plain = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)), **kw)
    assert torch.equal(out, plain.transpose(1, 2))  # the wrapper's CPU path is the plain version
    pallas = r_mha(jq, jk, jv, bq=128, bk=128, interpret=True, **kw)
    oracle = r_attention_ref(*(x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)), **kw)
    _close(out, pallas, TOL[dtype])
    _close(out, oracle.transpose(0, 2, 1, 3), TOL[dtype])


@pytest.mark.parametrize("case", DECODE_CASES + chip_smoke.WIDE_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_version_matches_reference(case, dtype):
    B, Sc, H, KV, dh = case
    rng = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((B, H, dh), (B, Sc, KV, dh), (B, Sc, KV, dh))
    )
    pos = rng.integers(1, Sc, B)
    valid = np.arange(Sc)[None, :] <= pos[:, None]
    valid[0, : Sc // 2] = False  # a row whose first slots are masked
    launches = t_dec.decode.launches
    out = t_dec.decode(q, k, v, torch.from_numpy(valid))
    assert t_dec.decode.launches == launches
    assert out.shape == (B, H, dh) and out.dtype == q.dtype
    assert torch.equal(out, decode_ref(q, k, v, torch.from_numpy(valid)))
    _close(out, r_decode(jq, jk, jv, jnp.asarray(valid), interpret=True), TOL[dtype])
    _close(out, r_decode_ref(jq, jk, jv, jnp.asarray(valid)), TOL[dtype])
    # q as [B,1,H,dh], the model's layout
    out4 = t_dec.decode(q[:, None], k, v, torch.from_numpy(valid))
    assert out4.shape == (B, 1, H, dh) and torch.equal(out4[:, 0], out)


def test_decode_row_without_valid_slots_is_the_reference_kernels():
    """No valid slot: the TPU kernel's finite -1e30 gives the mean of v."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s, np.float32) for s in ((2, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32)))
    valid = np.ones((2, 96), bool)
    valid[1] = False
    out = t_dec.decode(*(torch.from_numpy(x) for x in (q, k, v, valid)))
    ref = r_decode(*(jnp.asarray(x) for x in (q, k, v, valid)), interpret=True)
    _close(out, ref, TOL["float32"])
    mean_v = np.repeat(v[1].mean(0), 2, axis=0)  # heads 2g, 2g+1 read kv head g
    np.testing.assert_allclose(out[1].numpy(), mean_v, atol=1e-5)


@pytest.mark.parametrize(
    "window,chunk_local,causal", [(0, False, True), (48, False, True), (32, True, True), (0, False, False)]
)
def test_chunked_attention_matches_reference(window, chunk_local, causal):
    B, S, H, KV, dh = 2, 128, 4, 2, 32
    rng = np.random.default_rng(3)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.standard_normal(s, np.float32), "bfloat16")
        for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh))
    )
    kw = dict(causal=causal, window=window, chunk_local=chunk_local)
    out = t_attn.chunked_attention(q, k, v, **kw)
    ref = r_attn.chunked_attention(jq, jk, jv, q_chunk=32, **kw)
    _close(out, ref, 2e-2)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("case", chip_smoke.MLA_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_with_narrower_v_matches_reference(case, dtype, cap):
    """V heads narrower than Q/K heads (MLA: dv 64 / dh 96, and 32 / 48 at
    reduced width), causal, windowed and chunk-local, with and without a
    cap: the wrapper's CPU path (the plain version) against the reference's
    `chunked_attention` on the same inputs, [B,S,H,dv] out, scale dh^-0.5.
    The reference reads a band of 2 x window keys for a chunk-local query
    chunk; its `q_chunk` of 32 (at most the window) keeps that band exact
    (ROADMAP.md §C, C5). bf16 at 2e-2 (the reference rounds P to bf16)."""
    B, S, H, KV, dh, causal, window, cl, dv = case
    rng = np.random.default_rng(5)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dv))
    )
    kw = dict(causal=causal, window=window, chunk_local=cl, logit_cap=cap)
    out = t_attn.chunked_attention(q, k, v, **kw)
    assert out.shape == (B, S, H, dv) and out.dtype == q.dtype
    plain = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)), **kw)
    assert torch.equal(out, plain.transpose(1, 2))
    ref = r_attn.chunked_attention(jq, jk, jv, q_chunk=32, **kw)
    _close(out, ref, TOL[dtype] if dtype == "float32" else 2e-2)


def test_decode_attention_matches_reference():
    B, Sc, H, KV, dh = 3, 80, 6, 2, 32
    rng = np.random.default_rng(4)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.standard_normal(s, np.float32), "bfloat16")
        for s in ((B, 1, H, dh), (B, Sc, KV, dh), (B, Sc, KV, dh))
    )
    valid = np.arange(Sc)[None, :] <= np.array([0, 40, 79])[:, None]
    out = t_attn.decode_attention(q, k, v, torch.from_numpy(valid))
    ref = r_attn.decode_attention(jq, jk, jv, jnp.asarray(valid))
    assert out.shape == (B, 1, H, dh)
    _close(out, ref, 2e-2)


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_cuda_tensor_whose_binding_fails_raises(kernel, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: a binding
    that cannot load never turns into the plain version's result."""

    def broken(name):
        raise OSError(f"cannot load lib{name}.so")

    monkeypatch.setattr(_build, "load", broken)
    t_flash_bind.entry.cache_clear()
    t_dec_bind.entry.cache_clear()
    counters = (t_flash.mha.launches, t_dec.decode.launches)
    with FakeTensorMode():  # tensors that say cuda, without a card
        kv = torch.empty((1, 16, 2, 32), device="cuda")
        with pytest.raises(OSError, match="cannot load"):
            if kernel == "flash":
                t_flash.mha(torch.empty((1, 16, 4, 32), device="cuda"), kv, kv)
            else:
                valid = torch.empty((1, 16), dtype=torch.bool, device="cuda")
                t_dec.decode(torch.empty((1, 4, 32), device="cuda"), kv, kv, valid)
    assert (t_flash.mha.launches, t_dec.decode.launches) == counters
    t_flash_bind.entry.cache_clear()
    t_dec_bind.entry.cache_clear()


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError, match="multiple of KV"):
        t_flash.mha(q, torch.zeros((1, 8, 3, 32)), torch.zeros((1, 8, 3, 32)))
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        t_flash.mha(q, q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 8, 4, 264))
        t_flash.mha(big, big, big)
    with pytest.raises(ValueError, match="q_len == kv_len"):
        t_flash.mha(q, torch.zeros((1, 9, 4, 32)), torch.zeros((1, 9, 4, 32)))
    kv = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError, match="dv <= dh"):  # V wider than Q/K
        t_flash.mha(q, kv, torch.zeros((1, 8, 4, 48)))
    with pytest.raises(ValueError, match="dv <= dh"):  # V's heads or length differ from K's
        t_flash.mha(q, kv, torch.zeros((1, 8, 2, 32)))
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        t_flash.mha(q, kv, torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16))
    cache = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="valid must be bool"):
        t_dec.decode(q[:, 0], cache, cache, torch.ones((1, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        t_dec.decode(q[:, 0], cache.transpose(1, 2).contiguous().transpose(1, 2), cache,
                     torch.ones((1, 8), dtype=torch.bool))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES + chip_smoke.WIDE_FLASH_CASES):
            chip_smoke.check_flash(case, dtype, dev, seed=i)
        for i, case in enumerate(DECODE_CASES + chip_smoke.WIDE_DECODE_CASES):
            chip_smoke.check_decode(case, dtype, dev, seed=i)
        for i, (case, cap) in enumerate(chip_smoke.EXTRA_FLASH_CASES):
            chip_smoke.check_flash(case, dtype, dev, seed=i, logit_cap=cap)
        for i, (case, pattern) in enumerate(chip_smoke.EXTRA_DECODE_CASES):
            chip_smoke.check_decode(case, dtype, dev, seed=i, pattern=pattern)
        for i, case in enumerate(chip_smoke.MLA_FLASH_CASES):  # V narrower than Q/K
            chip_smoke.check_flash(case, dtype, dev, seed=i)
    # bf16 per query row, and two calls bit for bit
    for case, cap in chip_smoke.EXTRA_FLASH_CASES:
        chip_smoke.check_tight("flash", case, dev, logit_cap=cap)
    for case, pattern in chip_smoke.EXTRA_DECODE_CASES:
        chip_smoke.check_tight("decode", case, dev, pattern=pattern)
