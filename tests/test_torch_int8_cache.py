"""The port's int8 KV cache against the reference's (`kv_cache_dtype="int8"`,
`repro.models.attention._kv_quantize` / `_kv_dequantize`): the quantizer
bit for bit, the cache leaves after prefill and decode, the plain int8
decode, and the port's counterpart of
`tests/models/test_int8_cache.py::test_int8_cache_matches_bf16` with its
limits (prefill logits 1e-3 abs / rel, decode logits 0.05 relative to their
largest). That file's `test_int8_cache_specs_halve_bytes` has its
counterpart in `tests/test_torch_flops.py`, beside the port's `flops.py`.

Tolerances: the quantizer is exact on equal inputs. Cache values from the
two packages' own bf16 products are held within one int8 step (the bf16
K/V under them differ by an ulp where the products sum in another order),
their scales at the bf16 limit 2e-2 relative; the plain decode at the
reference kernel tests' 2e-5 (float32) / 2e-2 (bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import attention as r_attn
from repro.models import stack as r_stack
from repro.models.schema import init_params as r_init_params
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.kernels.decode_attention import ops as t_dec
from repro_torch.kernels.decode_attention.ref import decode_int8_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import stack as t_stack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _int8(cfg):
    return dataclasses.replace(cfg, kv_cache_dtype="int8")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _weights(arch):
    p = r_init_params(r_stack.build_schema(r_registry.reduced(arch)), jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_is_the_references_bit_for_bit(dtype):
    """Equal inputs give the reference's int8 values and float32 scales bit
    for bit (its stack calls the quantizer op by op, as here); rows of zeros
    take the 1e-8 floor, and values at half-integer multiples of the scale
    round half to even. Compiled with `jax.jit`, the reference's division
    max|x| / 127 becomes a product with the float32 constant 1/127 (XLA's
    rewrite of a division by a constant), one ulp off in a few % of the
    scales: there the port is held within one ulp of the scale and one
    int8 step."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 40, 4, 32)) * rng.uniform(0.01, 30, (3, 40, 4, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0  # the scale's floor
    x[1, 1, 1, :3] = [127.0, 0.5, -2.5]  # scale 1: ties round to even
    x[1, 1, 1, 3:] = 0.0
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    q, s = t_attn._kv_quantize(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == x.shape[:3]
    rq, rs = jax.vmap(r_attn._kv_quantize, in_axes=1, out_axes=1)(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    cq, cs = jax.jit(jax.vmap(r_attn._kv_quantize, in_axes=1, out_axes=1))(jx)
    np.testing.assert_allclose(s.numpy(), np.asarray(cs), rtol=2**-23, atol=0)
    assert np.abs(q.numpy().astype(int) - np.asarray(cq, int)).max() <= 1
    assert q[1, 1, 1, :3].tolist() == [127, 0, -2] and s[0, 0, 0].item() == np.float32(1e-8)
    back = t_attn._kv_dequantize(q, s, tdt)
    ref = r_attn._kv_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), jdt)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_int8_decode_matches_reference(dtype):
    """The plain version of the int8 entry (dequantize to q's dtype, then
    the plain decode) against the reference's `_kv_dequantize` +
    `decode_attention`, over a partly valid cache; the wrapper on CPU
    tensors is that plain version."""
    jdt, tdt = DTYPES[dtype]
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(1)
    B, Sc, H, KV, dh = 3, 70, 6, 2, 24
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, Sc, KV, dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, Sc, KV, dh)).astype(np.int8)
    ks, vs = (rng.uniform(1e-3, 0.05, (B, Sc, KV)).astype(np.float32) for _ in range(2))
    valid = np.arange(Sc)[None] <= np.array([5, 69, 30])[:, None]
    ref = r_attn.decode_attention(
        jnp.asarray(q, jdt), r_attn._kv_dequantize(jnp.asarray(k8), jnp.asarray(ks), jdt),
        r_attn._kv_dequantize(jnp.asarray(v8), jnp.asarray(vs), jdt), jnp.asarray(valid))
    t = [torch.from_numpy(x) for x in (q, k8, v8, ks, vs, valid)]
    tq = t[0].to(tdt)
    plain = decode_int8_ref(tq[:, 0], *t[1:5], t[5])
    launches = t_dec.decode.launches
    out = t_dec.decode(tq, t[1], t[2], t[5], k_scale=t[3], v_scale=t[4])
    assert t_dec.decode.launches == launches  # CPU: the plain version, no launch
    assert torch.equal(out[:, 0], plain) and out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_decode_wrapper_checks_the_scales():
    q = torch.zeros((1, 4, 16))
    c8 = torch.zeros((1, 8, 2, 16), dtype=torch.int8)
    valid = torch.ones((1, 8), dtype=torch.bool)
    sc = torch.ones((1, 8, 2))
    with pytest.raises(ValueError, match="k_scale"):
        t_dec.decode(q, c8, c8, valid)
    with pytest.raises(ValueError, match="v_scale"):
        t_dec.decode(q, c8, c8, valid, k_scale=sc, v_scale=sc[:, :4])
    with pytest.raises(ValueError, match="k_scale"):
        t_dec.decode(q, c8, c8, valid, k_scale=sc.double(), v_scale=sc)
    with pytest.raises(ValueError, match="int8 cache only"):
        t_dec.decode(q, c8.float(), c8.float(), valid, k_scale=sc, v_scale=sc)
    with pytest.raises(TypeError, match="both int8"):
        t_dec.decode(q, c8, c8.float(), valid, k_scale=sc, v_scale=sc)
    assert t_dec.decode(q, c8, c8, valid, k_scale=sc, v_scale=sc).shape == q.shape


@pytest.mark.parametrize("arch", ["qwen2-72b", "h2o-danube-3-4b"])
def test_int8_cache_matches_bf16(arch):
    """The port's counterpart of the reference test of the same name: one
    set of weights, the bf16 and the int8 cache; the prefill logits within
    1e-3 (the prefill attends over bf16 K/V in both), a decode step's
    within 0.05 of their largest."""
    cfg = t_registry.reduced(arch)
    cfg8 = _int8(cfg)
    params = t_stack.cast_weights(cfg, interop.params_from_numpy(_weights(arch), CPU))
    B, S = 2, 64
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))
    pre = {"tokens": toks[:, :S]}
    lp16, c16 = t_stack.forward_prefill(cfg, params, pre, S + 8)
    lp8, c8 = t_stack.forward_prefill(cfg8, params, pre, S + 8)
    np.testing.assert_allclose(lp16.float().numpy(), lp8.float().numpy(), atol=1e-3, rtol=1e-3)
    assert c8["blk0"]["k"].dtype == torch.int8 and c8["blk0"]["k_scale"].dtype == torch.float32
    pos = torch.full((B,), S, dtype=torch.int32)
    lg16, _ = t_stack.forward_decode(cfg, params, toks[:, S], pos, c16)
    lg8, _ = t_stack.forward_decode(cfg8, params, toks[:, S], pos, c8)
    a, b = lg16.float().numpy(), lg8.float().numpy()
    rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-9)
    assert rel < 0.05, rel


@pytest.mark.parametrize("arch,window", [("h2o-danube-3-4b", None), ("h2o-danube-3-4b", 16),
                                         ("qwen2-72b", None)])
def test_int8_cache_leaves_match_reference(arch, window):
    """The int8 cache after the prefill and after each of two decode steps
    against the reference's: int8 K/V within one step, scales within 2e-2
    of theirs, the int8 values equal where both packages' bf16 K/V are (the
    quantizer is the reference's bit for bit), and the logits within 0.05.
    window=16: the prefill of 40 ring-fills the int8 values and scales."""
    changes = dict(kv_cache_dtype="int8", **({"window": window} if window else {}))
    cfg_r = dataclasses.replace(r_registry.reduced(arch), **changes)
    cfg_t = dataclasses.replace(t_registry.reduced(arch), **changes)
    weights = _weights(arch)
    p_r = {k: jnp.asarray(v) for k, v in weights.items()}
    p_t = t_stack.cast_weights(cfg_t, interop.params_from_numpy(weights, CPU))
    B, S, cache_len = 2, 40, 48
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)
    lp_r, c_r = r_stack.forward_prefill(cfg_r, p_r, {"tokens": jnp.asarray(toks[:, :S])},
                                        cache_len)
    lp_t, c_t = t_stack.forward_prefill(cfg_t, p_t, {"tokens": torch.from_numpy(toks[:, :S])},
                                        cache_len)
    np.testing.assert_allclose(lp_t.float().numpy(), np.asarray(lp_r, np.float32), atol=0.05,
                               rtol=0.05)

    def compare(label):
        got = dict(_leaves(interop.cache_to_numpy(c_t)))
        ref = {k: np.asarray(v) for k, v in _leaves(c_r)}
        assert set(got) == set(ref) == {f"blk0.{n}" for n in ("k", "v", "k_scale", "v_scale")}
        for name, x in ref.items():
            assert got[name].shape == x.shape and got[name].dtype == x.dtype, (label, name)
            if x.dtype == np.int8:
                d = np.abs(got[name].astype(np.int32) - x.astype(np.int32))
                assert d.max() <= 1 and (d == 0).mean() > 0.97, (label, name, d.max())
            else:
                np.testing.assert_allclose(got[name], x, rtol=2e-2, atol=1e-8,
                                           err_msg=f"{label} {name}")
        if window:
            assert got["blk0.k"].shape[2] == window  # a ring

    compare("prefill")
    for t in (S, S + 1):
        pos = np.full(B, t, np.int32)
        lg_r, c_r = r_stack.forward_decode(cfg_r, p_r, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                                           c_r)
        lg_t, _ = t_stack.forward_decode(cfg_t, p_t, torch.from_numpy(toks[:, t]),
                                         torch.from_numpy(pos), c_t)
        np.testing.assert_allclose(lg_t.float().numpy(), np.asarray(lg_r, np.float32),
                                   atol=0.05, rtol=0.05)
        compare(f"decode {t}")


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "seamless-m4t-large-v2"])
def test_interop_carries_int8_and_nested_caches(arch):
    """The reference's int8 cache (int8 K/V, float32 scales) and an
    encoder-decoder's nested {"self", "xk", "xv"} cache cross as they are,
    every leaf bit for bit, and back."""
    cfg_r = r_registry.reduced(arch)
    if not cfg_r.is_encdec:
        cfg_r = _int8(cfg_r)
    p_r = {k: jnp.asarray(v) for k, v in _weights(arch).items()}
    rng = np.random.default_rng(2)
    toks = jnp.asarray(rng.integers(0, cfg_r.vocab, (2, 12)).astype(np.int32))
    batch = ({"frames": jnp.asarray(rng.standard_normal((2, 9, cfg_r.frontend_dim)), jnp.bfloat16),
              "dec_tokens": toks} if cfg_r.is_encdec else {"tokens": toks})
    _, cache_r = r_stack.forward_prefill(cfg_r, p_r, batch, 16)
    cache_t = interop.cache_from_numpy(jax.tree.map(np.asarray, cache_r), CPU)
    ref = dict(_leaves(cache_r))
    got = dict(_leaves(cache_t))
    assert set(got) == set(ref)
    for name, x in ref.items():
        assert str(got[name].dtype).split(".")[-1] == str(x.dtype), name
    back = dict(_leaves(interop.cache_to_numpy(cache_t)))
    for name, x in ref.items():
        np.testing.assert_array_equal(back[name], np.asarray(x, back[name].dtype), err_msg=name)
    if cfg_r.is_encdec:
        assert {n.split(".", 1)[1] for n in got} == {"self.k", "self.v", "xk", "xv"}
    else:
        assert {n.split(".", 1)[1] for n in got} == {"k", "v", "k_scale", "v_scale"}


@pytest.mark.cuda
def test_int8_kernel_is_the_bf16_kernel_on_the_dequantized_cache():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    for case in chip_smoke.INT8_DECODE_CASES:
        chip_smoke.check_decode_int8(case, torch.device("cuda"))
