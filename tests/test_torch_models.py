"""The port's model stack against the reference: configs, schema, layers,
and prefill / decode of the dense GQA family.

Tolerances: the registry, the schema and the embedding are exact. Layers
are held at 1e-6 in float32 and one bf16 ulp (2**-7 relative) in bf16. The
stacks' logits and caches are held at 0.05 abs/rel, the bf16 tolerance of
`tests/models/test_archs.py`: both stacks run their products in bf16, and
the port's attention kernels keep scores and probabilities in float32 where
the reference rounds them to bf16, and sum in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import layers as r_layers
from repro.models import stack as r_stack
from repro.models.config import LM_SHAPES as R_SHAPES
from repro.models.schema import init_params as r_init_params
from repro.models.schema import param_bytes as r_param_bytes
from repro.models.schema import param_count as r_param_count
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import stack as t_stack
from repro_torch.models.config import LM_SHAPES as T_SHAPES
from repro_torch.models.schema import init_params as t_init_params
from repro_torch.models.schema import param_bytes as t_param_bytes
from repro_torch.models.schema import param_count as t_param_count

ARCHS = r_registry.names()
LOGIT_TOL = 0.05
CPU = torch.device("cpu")


def test_registry_names_and_shapes():
    assert t_registry.names() == ARCHS and len(ARCHS) == 10
    assert [dataclasses.asdict(c) for c in T_SHAPES] == [dataclasses.asdict(c) for c in R_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_equal_reference(arch):
    for get in ("get", "reduced"):
        r_cfg = getattr(r_registry, get)(arch)
        t_cfg = getattr(t_registry, get)(arch)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(r_cfg), (arch, get)
        for prop in ("hd", "v_hd", "period", "n_groups", "has_mla", "is_encdec",
                     "sub_quadratic", "long_context_capable"):
            assert getattr(t_cfg, prop) == getattr(r_cfg, prop), (arch, get, prop)


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_equals_reference(arch):
    for cfg_of in (r_registry.get, r_registry.reduced):
        r_cfg = cfg_of(arch)
        t_cfg = getattr(t_registry, cfg_of.__name__)(arch)
        r_sch, t_sch = r_stack.build_schema(r_cfg), t_stack.build_schema(t_cfg)
        assert list(t_sch) == list(r_sch)
        for name, spec in r_sch.items():
            assert dataclasses.asdict(t_sch[name]) == dataclasses.asdict(spec), (arch, name)
        assert t_param_count(t_sch) == r_param_count(r_sch)
        assert t_param_bytes(t_sch) == r_param_bytes(r_sch)
    assert t_registry.get(arch).params_active() == r_registry.get(arch).params_active()


def test_init_params_follows_the_schema():
    cfg = t_registry.reduced("qwen2-72b")
    sch = t_stack.build_schema(cfg)
    p = t_init_params(sch, torch.Generator().manual_seed(0), CPU)
    q = t_init_params(sch, torch.Generator().manual_seed(0), CPU)
    assert list(p) == sorted(sch)
    for name, spec in sch.items():
        assert tuple(p[name].shape) == spec.shape and p[name].dtype == torch.float32
        assert torch.equal(p[name], q[name])  # seeded
    assert torch.all(p["blk0.mix.ln"] == 0) and torch.all(p["blk0.mix.bq"] == 0)
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    wq = p["blk0.mix.wq"]
    assert abs(wq.std().item() - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5


def test_embed_lookup_is_exactly_the_one_hot_product():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((300, 48), np.float32)
    ids = rng.integers(0, 300, (3, 17)).astype(np.int32)
    ref = r_layers.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.bfloat16)
    out = t_layers.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = 1e-6 if dtype == "float32" else 2**-7
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64), np.float32)
    scale = 0.1 * rng.standard_normal(64, np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    def close(out, ref):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)

    close(t_layers.rmsnorm(tx, torch.from_numpy(scale)), r_layers.rmsnorm(jx, jnp.asarray(scale)))
    np.testing.assert_allclose(t_layers.rope_freqs(32, 5e5).numpy(),
                               np.asarray(r_layers.rope_freqs(32, 5e5)), rtol=1e-6)
    xh = rng.standard_normal((2, 9, 4, 32), np.float32)
    pos = np.tile(np.arange(100, 109, dtype=np.int32), (2, 1))
    close(t_layers.apply_rope(torch.from_numpy(xh).to(tdt), torch.from_numpy(pos), 5e5),
          r_layers.apply_rope(jnp.asarray(xh, jdt), jnp.asarray(pos), 5e5))
    cfg = t_registry.reduced("llama3.2-3b")
    w = {f"f.{n}": 0.1 * rng.standard_normal(s, np.float32)
         for n, s in (("wg", (64, 96)), ("wu", (64, 96)), ("wd", (96, 64)))}
    out = t_layers.dense_ffn(cfg, {k: torch.from_numpy(v) for k, v in w.items()}, "f", tx)
    ref = r_layers.dense_ffn(r_registry.reduced("llama3.2-3b"),
                             {k: jnp.asarray(v) for k, v in w.items()}, "f", jx)
    # the gate and up products round to the working dtype before the
    # activation: one more rounding than the other layers
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=4 * tol, rtol=4 * tol)
    for name in ("silu", "gelu", "relu"):
        close(t_layers.act_fn(name)(tx), r_layers.act_fn(name)(jx))
    close(t_layers.softcap(tx, 2.0), r_layers.softcap(jx, 2.0))


def _weights(cfg_r):
    """Reference weights with the zero-initialized norm scales and biases
    perturbed, so every parameter reaches the logits; as numpy arrays."""
    p = r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    out = {}
    for name, x in p.items():
        x = np.asarray(x)
        if name.rsplit(".", 1)[-1] in ("ln", "ln2", "final_ln", "bq", "bk", "bv"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        out[name] = x
    return out


def _close(out, ref, label):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL, err_msg=label)


STACK_CASES = {
    # (arch, replace(...) of the reduced config, prompt length, cache_len)
    "llama3.2-3b": ("llama3.2-3b", dict(n_layers=2), 40, 48),
    "h2o-danube-3-4b": ("h2o-danube-3-4b", {}, 40, 48),
    "h2o-danube-3-4b-ring": ("h2o-danube-3-4b", dict(window=16), 40, 48),
    "qwen2-72b": ("qwen2-72b", {}, 40, 48),
}


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_prefill_and_decode_match_reference(case):
    arch, changes, S, cache_len = STACK_CASES[case]
    cfg_r = dataclasses.replace(r_registry.reduced(arch), **changes)
    cfg_t = dataclasses.replace(t_registry.reduced(arch), **changes)
    weights = _weights(cfg_r)
    p_r = {k: jnp.asarray(v) for k, v in weights.items()}
    p_t = interop.params_from_numpy(weights, CPU)
    B = 2
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)

    lp_r, cache_r = r_stack.forward_prefill(cfg_r, p_r, {"tokens": jnp.asarray(toks[:, :S])},
                                            cache_len)
    prefill = t_model.make_prefill_step(cfg_t, cache_len)
    lp_t, cache_t = prefill(t_stack.cast_weights(p_t), {"tokens": torch.from_numpy(toks[:, :S])})
    assert lp_t.shape == (B, cfg_t.vocab) and lp_t.dtype == torch.bfloat16
    _close(lp_t.float().numpy(), lp_r, f"{case} prefill logits")
    got = interop.cache_to_numpy(cache_t)
    assert set(got) == set(cache_r)
    for blk in cache_r:
        assert set(got[blk]) == set(cache_r[blk])
        for leaf, ref in cache_r[blk].items():
            assert got[blk][leaf].shape == ref.shape and cache_t[blk][leaf].dtype == torch.bfloat16
            _close(got[blk][leaf], ref, f"{case} prefill cache {blk}.{leaf}")
    if changes.get("window", cache_len) < S:
        assert cache_r["blk0"]["k"].shape[2] == changes["window"]  # a ring buffer was filled

    # two decode steps from the reference's own cache, carried across
    decode = t_model.make_decode_step(cfg_t)
    c_t = interop.cache_from_numpy({b: {k: np.asarray(v) for k, v in d.items()}
                                    for b, d in cache_r.items()}, CPU)
    c_r = cache_r
    for t in (S, S + 1):
        pos = np.full(B, t, np.int32)
        lg_r, c_r = r_stack.forward_decode(cfg_r, p_r, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                                           c_r)
        before = interop.cache_to_numpy(c_t)  # decode writes the port's cache in place
        lg_t, c_new = decode(p_t, torch.from_numpy(toks[:, t]), torch.from_numpy(pos), c_t)
        assert c_new is c_t
        assert any(not np.array_equal(before[b][k], v)
                   for b, d in interop.cache_to_numpy(c_t).items() for k, v in d.items())
        _close(lg_t.float().numpy(), lg_r, f"{case} decode logits at {t}")
        got = interop.cache_to_numpy(c_t)
        for blk in c_r:
            for leaf, ref in c_r[blk].items():
                _close(got[blk][leaf], ref, f"{case} decode cache {blk}.{leaf} at {t}")


def test_cast_weights_are_bitwise_a_per_call_cast():
    cfg = dataclasses.replace(t_registry.reduced("qwen2-72b"), n_layers=1)
    p = t_init_params(t_stack.build_schema(cfg), torch.Generator().manual_seed(1), CPU)
    for k in p:
        if k.endswith((".ln", ".ln2", "final_ln", ".bq", ".bk", ".bv")):
            p[k] = p[k] + 0.1
    cast = t_stack.cast_weights(p)
    assert t_stack.ACT_DTYPE == torch.bfloat16  # the reference's activations
    assert cast["embed"].dtype == torch.bfloat16 and cast["blk0.mix.wq"].dtype == torch.bfloat16
    assert cast["blk0.mix.ln"] is p["blk0.mix.ln"] and cast["final_ln"].dtype == torch.float32
    toks = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(2))}
    a, ca = t_stack.forward_prefill(cfg, p, toks, 16)
    b, cb = t_stack.forward_prefill(cfg, cast, toks, 16)
    assert torch.equal(a, b) and torch.equal(ca["blk0"]["k"], cb["blk0"]["k"])


@pytest.mark.parametrize(
    "arch,changes,item",
    [
        ("minicpm3-4b", {}, "A9"),  # mla
        ("xlstm-350m", {}, "A8"),  # mlstm / slstm
        ("recurrentgemma-9b", {}, "A8"),  # rglru
        ("mixtral-8x7b", {}, "A9"),  # moe
        ("llama4-scout-17b-a16e", {}, "A9"),  # moe
        ("seamless-m4t-large-v2", {}, "A9"),  # encoder-decoder + audio frontend
        ("internvl2-26b", {}, "A9"),  # vision frontend
        ("llama3.2-3b", {"kv_cache_dtype": "int8"}, "A9"),
        ("llama3.2-3b", {"attn_softcap": 30.0}, "A9"),
    ],
)
def test_unported_mixers_and_options_raise(arch, changes, item):
    cfg = dataclasses.replace(t_registry.reduced(arch), **changes)
    msg = f"ROADMAP.md §A item {item}"
    with pytest.raises(NotImplementedError, match=msg):
        t_stack.init_cache(cfg, 1, 8, CPU)
    with pytest.raises(NotImplementedError, match=msg):
        t_stack.forward_prefill(cfg, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 8)
    with pytest.raises(NotImplementedError, match=msg):
        z = torch.zeros((1,), dtype=torch.int32)
        t_stack.forward_decode(cfg, {}, z, z, {})


def test_moe_ffn_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A item A9"):
        t_layers.ffn(t_registry.reduced("mixtral-8x7b"), {}, "f", "moe", torch.zeros((1, 2, 8)))


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_registry.reduced("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_stack.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_init_params(t_stack.build_schema(cfg), torch.Generator())
