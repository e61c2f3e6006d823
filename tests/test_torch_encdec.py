"""The port's frontends and encoder-decoder against the reference: the
vision frontend (internvl2-26b), the audio encoder-decoder with its
cross-attention (seamless-m4t-large-v2), flash with a key length of its
own, decode over an empty memory, `layernorm` / `norm`, and the router
over an encoder-decoder.

Tolerances: the stacks' logits and caches at 0.05 abs / rel (bf16, as
`tests/models/test_archs.py`); the attention contract functions in float32
at the reference kernel tests' 2e-5; the norms at 1e-6 in float32 and one
bf16 ulp in bf16 (as `tests/test_torch_models.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as r_registry
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import stack as r_stack
from repro.models.schema import init_params as r_init_params
from repro.serving import engine as r_engine
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.kernels.decode_attention import ops as t_dec
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import stack as t_stack
from repro_torch.serving import engine as t_engine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LOGIT_TOL = 0.05
F32_TOL = 2e-5
STEPS = 4  # decode steps after the prefill
POD_ARGS = [(0, 12), (30_000, 12), (100_000, 12)]  # the launcher's pods


def _weights(cfg_r):
    """Reference weights, norm scales perturbed so each reaches the logits."""
    p = r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    out = {}
    for name, x in p.items():
        x = np.asarray(x)
        if name.rsplit(".", 1)[-1] in ("ln", "ln2", "final_ln", "enc_final_ln"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        out[name] = x
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _close(out, ref, label, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=label)


def _batches(cfg, B, rng):
    """(reference batch, port batch, first decode position, decode tokens)
    of a vision model (8 patches + 24 tokens) or an encoder-decoder (40
    frames, 16 decoder tokens)."""
    toks = rng.integers(0, cfg.vocab, (B, 24 + STEPS)).astype(np.int32)
    if cfg.is_encdec:
        frames = rng.standard_normal((B, 40, cfg.frontend_dim)).astype(np.float32)
        np_batch = {"frames": frames, "dec_tokens": toks[:, :16]}
        start, rest = 16, toks[:, 16:16 + STEPS]
    else:
        patches = rng.standard_normal((B, 8, cfg.frontend_dim)).astype(np.float32)
        np_batch = {"patches": patches, "tokens": toks[:, :24]}
        start, rest = 32, toks[:, 24:24 + STEPS]
    r_batch = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
               for k, v in np_batch.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    t_batch = {k: v.bfloat16() if v.is_floating_point() else v for k, v in t_batch.items()}
    return r_batch, t_batch, start, rest


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_prefill_and_decode_match_reference(arch):
    """Prefill, then STEPS decode steps, each package from its own cache:
    the logits at every step and every cache leaf (an encoder-decoder's
    nested self cache and cross K/V included) within 0.05."""
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    weights = _weights(cfg_r)
    p_r = {k: jnp.asarray(v) for k, v in weights.items()}
    p_t = t_stack.cast_weights(cfg_t, interop.params_from_numpy(weights, CPU))
    B, cache_len = 2, 48
    r_batch, t_batch, start, rest = _batches(cfg_r, B, np.random.default_rng(6))
    lp_r, c_r = r_stack.forward_prefill(cfg_r, p_r, r_batch, cache_len)
    lp_t, c_t = t_model.make_prefill_step(cfg_t, cache_len)(p_t, t_batch)
    assert lp_t.shape == (B, cfg_t.vocab) and torch.isfinite(lp_t.float()).all()
    _close(lp_t.float().numpy(), lp_r, f"{arch} prefill logits")

    def caches(label):
        got = dict(_leaves(interop.cache_to_numpy(c_t)))
        ref = dict(_leaves(c_r))
        assert set(got) == set(ref), label
        for name, x in ref.items():
            assert got[name].shape == x.shape, (label, name)
            _close(got[name], x, f"{arch} {label} cache {name}")
        return got

    got = caches("prefill")
    if cfg_r.is_encdec:
        assert {n for n in got if n.endswith((".xk", ".xv"))} == {"blk0.xk", "blk0.xv"}
        assert got["blk0.xk"].shape[2] == 40  # the memory's 40 frames
    decode = t_model.make_decode_step(cfg_t)
    for i in range(STEPS):
        pos = np.full(B, start + i, np.int32)
        lg_r, c_r = r_stack.forward_decode(cfg_r, p_r, jnp.asarray(rest[:, i]), jnp.asarray(pos),
                                           c_r)
        lg_t, _ = decode(p_t, torch.from_numpy(rest[:, i]), torch.from_numpy(pos), c_t)
        _close(lg_t.float().numpy(), lg_r, f"{arch} decode logits at {start + i}")
    caches(f"after {STEPS} decode steps")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_matches_reference(dtype):
    """`cross_attn` (no RoPE, no bias, non-causal, 12 decoder tokens over
    40 frames) against the reference's, and the K/V it hands the cache
    against the reference's prefill products."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = F32_TOL if dtype == "float32" else 2e-2
    cfg = t_registry.reduced("seamless-m4t-large-v2")
    rng = np.random.default_rng(2)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    w = {f"x.{n}": (0.1 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("wq", (D, H, hd)), ("wk", (D, KV, hd)), ("wv", (D, KV, hd)),
                      ("wo", (H, hd, D)))}
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    mem = rng.standard_normal((2, 40, D)).astype(np.float32)
    ref = r_attn.cross_attn(cfg, {k: jnp.asarray(v) for k, v in w.items()}, "x",
                            jnp.asarray(x, jdt), jnp.asarray(mem, jdt))
    out, (k, v) = t_attn.cross_attn(cfg, {k: torch.from_numpy(v) for k, v in w.items()}, "x",
                                    torch.from_numpy(x).to(tdt), torch.from_numpy(mem).to(tdt))
    _close(out.float().numpy(), ref, "cross_attn", tol)
    mem_r = jnp.asarray(mem, jdt)
    for t_kv, name in ((k, "wk"), (v, "wv")):
        r_kv = jnp.einsum("bmd,dnk->bmnk", mem_r, jnp.asarray(w[f"x.{name}"]).astype(jdt))
        _close(t_kv.float().numpy(), r_kv, f"cross {name}", tol)


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, dh): seamless's cross shape cut down; Sq below one
    # 64-row tile; Sk ragged across a 64-key tile; Sq > Sk; grouped heads
    (2, 12, 40, 4, 4, 32), (1, 5, 130, 2, 1, 64), (2, 70, 17, 6, 2, 16)])
def test_flash_with_its_own_key_length_matches_reference(case):
    """The plain flash and the wrapper at Sq != Sk (non-causal) against the
    reference's `chunked_attention(causal=False)` in float32 at 2e-5."""
    B, Sq, Sk, H, KV, dh = case
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, dh)).astype(np.float32)
    ref = r_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                          causal=False).transpose(1, 2)
    _close(plain.numpy(), ref, "plain", F32_TOL)
    _close(t_attn.chunked_attention(tq, tk, tv, causal=False).numpy(), ref, "wrapper", F32_TOL)


def test_flash_takes_its_own_key_length_only_without_masks():
    q, kv = torch.zeros((1, 8, 4, 32)), torch.zeros((1, 9, 4, 32))
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="q_len == kv_len"):
            t_flash.mha(q, kv, kv, **kw)
    with pytest.raises(ValueError, match="Sk > 0"):
        t_flash.mha(q, kv[:, :0], kv[:, :0], causal=False)
    assert t_flash.mha(q, kv, kv, causal=False).shape == (1, 8, 4, 32)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_decode_over_an_empty_memory_is_zeros(device):
    """Sc = 0 gives zeros, the reference's value (its softmax over no
    slots), with no launch: counted in `decode.empty_calls`. On a tensor
    that says cuda (no card needed) the wrapper neither builds nor
    launches."""
    B, H, KV, dh = 2, 4, 4, 16
    q = np.random.default_rng(0).standard_normal((B, 1, H, dh)).astype(np.float32)
    ref = r_attn.decode_attention(jnp.asarray(q), jnp.zeros((B, 0, KV, dh)),
                                  jnp.zeros((B, 0, KV, dh)), jnp.ones((B, 0), bool))
    assert ref.shape == (B, 1, H, dh) and not np.asarray(ref).any()
    before = (t_dec.decode.launches, t_dec.decode.empty_calls)
    ctx = FakeTensorMode() if device == "cuda" else torch.no_grad()
    with ctx:
        tq = torch.empty((B, H, dh), device=device)
        kv = torch.empty((B, 0, KV, dh), device=device)
        out = t_dec.decode(tq, kv, kv, torch.ones((B, 0), dtype=torch.bool, device=device))
        assert out.shape == (B, H, dh) and out.device.type == device
    if device == "cpu":
        assert not out.any()
    assert (t_dec.decode.launches, t_dec.decode.empty_calls) == (before[0], before[1] + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_norm_match_reference(dtype):
    """`layernorm` and `norm` as the reference's; `norm` follows
    `cfg.norm`, which the forward passes never read (ROADMAP §C, C7)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = 1e-6 if dtype == "float32" else 2**-7
    rng = np.random.default_rng(4)
    x = (3 + rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    js, ts = jnp.asarray(scale), torch.from_numpy(scale)
    _close(t_layers.layernorm(tx, ts, torch.from_numpy(bias)).float().numpy(),
           r_layers.layernorm(jx, js, jnp.asarray(bias)), "layernorm", tol)
    for arch in ("seamless-m4t-large-v2", "llama3.2-3b"):  # layernorm, rmsnorm
        r_cfg, t_cfg = r_registry.reduced(arch), t_registry.reduced(arch)
        _close(t_layers.norm(t_cfg, tx, ts).float().numpy(), r_layers.norm(r_cfg, jx, js),
               f"norm {arch}", tol)


def test_encoder_decoder_forward_runs_rmsnorm_as_the_reference():
    """seamless sets norm="layernorm", yet the reference's forward passes
    call rmsnorm only: a prefill of its reduced config is the same with
    norm="rmsnorm" in both packages."""
    cfg_t = t_registry.reduced("seamless-m4t-large-v2")
    assert cfg_t.norm == "layernorm"
    p = t_stack.cast_weights(cfg_t, interop.params_from_numpy(
        _weights(r_registry.reduced("seamless-m4t-large-v2")), CPU))
    _, t_batch, _, _ = _batches(cfg_t, 1, np.random.default_rng(1))
    a, _ = t_stack.forward_prefill(cfg_t, p, t_batch, 24)
    b, _ = t_stack.forward_prefill(dataclasses.replace(cfg_t, norm="rmsnorm"), p, t_batch, 24)
    assert torch.equal(a, b)


def test_frontend_and_cross_weights_cast_once():
    """`cast_weights` casts the vision / audio projection, the encoder's
    layers and the cross-attention's products, and leaves their norm
    scales float32."""
    for arch, cast, keep in [
        ("internvl2-26b", ["frontend_proj", "blk0.mix.wq"], ["blk0.mix.ln"]),
        ("seamless-m4t-large-v2",
         ["frontend_proj", "eblk0.mix.wq", "eblk0.mix.wo", "eblk0.ffn.wg", "blk0.x.wq",
          "blk0.x.wk", "blk0.x.wv", "blk0.x.wo"],
         ["eblk0.mix.ln", "eblk0.ffn.ln2", "blk0.x.ln", "enc_final_ln"])]:
        cfg = t_registry.reduced(arch)
        p = interop.params_from_numpy(_weights(r_registry.reduced(arch)), CPU)
        out = t_stack.cast_weights(cfg, p)
        for name in cast:
            assert out[name].dtype == torch.bfloat16 and torch.equal(out[name],
                                                                     p[name].bfloat16()), name
        for name in keep:
            assert out[name] is p[name], name


def test_cache_specs_take_the_memory_length():
    """An encoder-decoder's cache: {"self", "xk", "xv"} a layer, the cross
    K/V [G,B,enc_len,KV,hd] in bf16 (enc_len = 0 by default: the router's
    empty memory), as the reference's `decode_cache_specs`."""
    cfg_r = r_registry.reduced("seamless-m4t-large-v2")
    cfg_t = t_registry.reduced("seamless-m4t-large-v2")
    for enc_len in (0, 7):
        ref = dict(_leaves(r_stack.decode_cache_specs(cfg_r, 3, 16, enc_len)))
        cache = dict(_leaves(t_stack.init_cache(cfg_t, 3, 16, CPU, enc_len=enc_len)))
        assert set(cache) == set(ref)
        for name, spec in ref.items():
            assert tuple(cache[name].shape) == spec.shape, name
            assert str(cache[name].dtype).split(".")[-1] == str(spec.dtype), name


@pytest.mark.parametrize("policy", ["geotp", "fcfs"])
def test_router_over_an_encoder_decoder_matches_reference(policy):
    """The router with run_model=True over reduced seamless: its pods hold
    enc_len = 0 caches and each generation's decode step runs its cross
    step over an empty memory (zeros, no launch): summaries, latency and
    occupancy lists equal to the reference's."""
    cfg_r = r_registry.reduced("seamless-m4t-large-v2")
    cfg_t = t_registry.reduced("seamless-m4t-large-v2")
    weights = {k: np.asarray(v) for k, v in
               r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(0)).items()}
    runs = []
    for mod, kw in ((r_engine, {}),
                    (t_engine, dict(device="cpu", params=interop.params_from_numpy(weights, CPU)))):
        eng = mod.GeoServingEngine(cfg_r if mod is r_engine else cfg_t,
                                   [mod.PodConfig(rtt_us=r, n_slots=n) for r, n in POD_ARGS],
                                   policy=policy, run_model=True, **kw)
        for r in mod.synthetic_workload(12, len(POD_ARGS), rate_per_s=100.0):
            eng.submit(r)
        runs.append((eng, eng.run(until_us=120_000_000)))
    (er, res_r), (et, res_t) = runs
    empty = t_dec.decode.empty_calls
    assert res_t == res_r and res_t["completed"] == 12
    assert et.stats.lat_us == er.stats.lat_us and et.stats.occ_us == er.stats.occ_us
    assert et.pools[0].cache["blk0"]["xk"].shape[2] == 0
    assert empty > 0
