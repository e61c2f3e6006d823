"""The port's model stack against the reference: configs, schema, layers,
and prefill / decode of the dense GQA family, MLA, the MoE models and the
recurrent families.

Tolerances: the registry, the schema and the embedding are exact. Layers
are held at 1e-6 in float32 and one bf16 ulp (2**-7 relative) in bf16. The
stacks' logits and caches are held at the bf16 tolerances of
`tests/models/test_archs.py`, 0.05 abs/rel (0.08 for recurrent stacks):
both stacks run their products in bf16, and the port's attention kernels
keep scores and probabilities in float32 where the reference rounds them to
bf16, and sum in another order.

xLSTM is held layer by layer in bf16 (each of the port's layers on the
reference's own input and cache, at 0.08) and free-running in float32
(1e-4): a free-running bf16 xLSTM stack is chaotic at these random weights.
One bf16 ulp on 0.1% of the reference's own embedding entries moves its
logits by 0.34 and its matrix memories by 0.4 beyond the 0.08 limit, so no
implementation short of bitwise XLA:CPU arithmetic stays within it.

The MoE stacks' routing is compared as well: equal in float32; in bf16 a
top-k decision at an exact tie of the reference's gates may go the other
way (MOE_CASES below), and those tokens are counted, not compared.
"""

import dataclasses
import pathlib

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
from repro_torch.models import routelog
from repro_torch.models import stack as t_stack
from repro_torch.models.config import LM_SHAPES as T_SHAPES
from repro_torch.models.schema import init_params as t_init_params
from repro_torch.models.schema import param_bytes as t_param_bytes
from repro_torch.models.schema import param_count as t_param_count
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = r_registry.names()
LOGIT_TOL = 0.05
RECURRENT_TOL = 0.08  # tests/models/test_archs.py: recurrent stacks
CPU = torch.device("cpu")


def test_registry_names_and_shapes():
    assert t_registry.names() == ARCHS and len(ARCHS) == 10
    assert [dataclasses.asdict(c) for c in T_SHAPES] == [dataclasses.asdict(c) for c in R_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_equal_reference(arch):
    """Every field the reference has is equal; the port's one field of its
    own, `irope`, holds the rule the reference decides from the name."""
    for get in ("get", "reduced"):
        r_cfg = getattr(r_registry, get)(arch)
        t_cfg = getattr(t_registry, get)(arch)
        r_fields, t_fields = dataclasses.asdict(r_cfg), dataclasses.asdict(t_cfg)
        assert set(t_fields) - set(r_fields) == {"irope"}, (arch, get)
        assert {k: t_fields[k] for k in r_fields} == r_fields, (arch, get)
        assert t_cfg.irope == r_cfg.name.startswith("llama4"), (arch, get)
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


def _close(out, ref, label, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=label)


def _leaves(tree, prefix=""):
    """(dotted name, leaf) of a nested cache, in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _leaf_dtype(name):
    """The port's cache dtypes: bf16 K/V, MLA latents and conv buffers,
    float32 states."""
    bf16 = ("k", "v", "c_kv", "k_rope", "conv")
    return torch.bfloat16 if name.rsplit(".", 1)[-1] in bf16 else torch.float32


def _tol(cfg):
    recurrent = any(m in ("mlstm", "slstm", "rglru") for m, _ in cfg.pattern)
    return RECURRENT_TOL if recurrent else LOGIT_TOL


STACK_CASES = {
    # (arch, replace(...) of the reduced config, prompt length, cache_len)
    "llama3.2-3b": ("llama3.2-3b", dict(n_layers=2), 40, 48),
    "h2o-danube-3-4b": ("h2o-danube-3-4b", {}, 40, 48),
    "h2o-danube-3-4b-ring": ("h2o-danube-3-4b", dict(window=16), 40, 48),
    "qwen2-72b": ("qwen2-72b", {}, 40, 48),
    # rglru x 4 and softcapped local attention; the ring case wraps a
    # 16-slot ring under the cap
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, 40, 48),
    "recurrentgemma-9b-ring": ("recurrentgemma-9b", dict(window=16), 40, 48),
    # MoE (reduced: 4 experts; mixtral top-2 over swa, llama4 top-1 over 3
    # cla + 1 NoPE gqa). The reduced configs' capacity factor 8.0 drops
    # nothing; 1.0 drops assignments in the prefill. window=16: the swa ring
    # wraps at S = 40. llama4 at window=24: two chunks in the prefill, the
    # ring wraps, decode starts mid-chunk, and the NoPE layers bite; the
    # reference's chunk-local band is exact only for S <= 2 x window at
    # these lengths (ROADMAP.md §C, C5), so its window 16 would hold the
    # port to the reference's dropped keys. llama4 without drops is held
    # layer by layer (MOE_CASES below)
    "mixtral-8x7b": ("mixtral-8x7b", {}, 40, 48),
    "mixtral-8x7b-ring": ("mixtral-8x7b", dict(window=16), 40, 48),
    "mixtral-8x7b-drops": ("mixtral-8x7b", dict(capacity_factor=1.0), 40, 48),
    "llama4-scout-drops": ("llama4-scout-17b-a16e", dict(window=24, capacity_factor=1.0), 40, 48),
    # MLA: the flash kernel's plain version with dv 32 < dh 48, the absorbed
    # decode over the compressed latent cache
    "minicpm3-4b": ("minicpm3-4b", {}, 40, 48),
}
# held layer by layer (bf16) and free-running in float32 below
LAYERWISE_CASES = {
    "xlstm-350m": ("xlstm-350m", {}, 40, 48),
    "recurrentgemma-9b-ring": STACK_CASES["recurrentgemma-9b-ring"],
}


def _cfgs(case, cases):
    arch, changes, S, cache_len = cases[case]
    cfg_r = dataclasses.replace(r_registry.reduced(arch), **changes)
    cfg_t = dataclasses.replace(t_registry.reduced(arch), **changes)
    return cfg_r, cfg_t, S, cache_len


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_prefill_and_decode_match_reference(case):
    cfg_r, cfg_t, S, cache_len = _cfgs(case, STACK_CASES)
    tol = _tol(cfg_r)
    weights = _weights(cfg_r)
    p_r = {k: jnp.asarray(v) for k, v in weights.items()}
    p_t = interop.params_from_numpy(weights, CPU)
    B = 2
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)

    lp_r, cache_r = r_stack.forward_prefill(cfg_r, p_r, {"tokens": jnp.asarray(toks[:, :S])},
                                            cache_len)
    prefill = t_model.make_prefill_step(cfg_t, cache_len)
    lp_t, cache_t = prefill(t_stack.cast_weights(cfg_t, p_t),
                            {"tokens": torch.from_numpy(toks[:, :S])})
    assert lp_t.shape == (B, cfg_t.vocab) and lp_t.dtype == torch.bfloat16
    _close(lp_t.float().numpy(), lp_r, f"{case} prefill logits", tol)
    ref_leaves = dict(_leaves(cache_r))
    got = dict(_leaves(interop.cache_to_numpy(cache_t)))
    assert set(got) == set(ref_leaves)
    for name, t_leaf in _leaves(cache_t):
        ref = ref_leaves[name]
        assert got[name].shape == ref.shape and t_leaf.dtype == _leaf_dtype(name), name
        _close(got[name], ref, f"{case} prefill cache {name}", tol)
    window = cfg_r.window
    if window < S and any(m == "swa" for m, _ in cfg_r.pattern):
        ring = [n for n in ref_leaves if n.endswith(".k")]
        assert all(ref_leaves[n].shape[2] == window for n in ring)  # a ring buffer was filled

    # two decode steps from the reference's own cache, carried across
    decode = t_model.make_decode_step(cfg_t)
    c_t = interop.cache_from_numpy(jax.tree.map(np.asarray, cache_r), CPU)
    c_r = cache_r
    for t in (S, S + 1):
        pos = np.full(B, t, np.int32)
        lg_r, c_r = r_stack.forward_decode(cfg_r, p_r, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                                           c_r)
        before = dict(_leaves(interop.cache_to_numpy(c_t)))  # decode writes in place
        lg_t, c_new = decode(p_t, torch.from_numpy(toks[:, t]), torch.from_numpy(pos), c_t)
        assert c_new is c_t
        got = dict(_leaves(interop.cache_to_numpy(c_t)))
        assert any(not np.array_equal(before[n], v) for n, v in got.items())
        _close(lg_t.float().numpy(), lg_r, f"{case} decode logits at {t}", tol)
        for name, ref in _leaves(c_r):
            _close(got[name], ref, f"{case} decode cache {name} at {t}", tol)


def _layer_params(weights, pfx, g):
    return {k: (v[g] if g is not None else v) for k, v in weights.items()
            if k.startswith(pfx + ".")}


@pytest.mark.parametrize("case", list(LAYERWISE_CASES))
def test_layers_match_reference_on_its_own_inputs(case):
    """Every layer of the port's bf16 stack, prefill then two decode steps,
    on the reference's input hidden state and (decode) the reference's
    cache: the layer's output and every cache leaf within 0.08, and the
    logits of the reference's final hidden state. The reference's layers are
    compiled with `jax.jit`, as its scanned stack runs them."""
    cfg_r, cfg_t, S, cache_len = _cfgs(case, LAYERWISE_CASES)
    weights = _weights(cfg_r)
    p_t = t_stack.cast_weights(cfg_t, interop.params_from_numpy(weights, CPU))
    B = 2
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    x_r = r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(toks[:, :S]))
    cache_t = t_stack.init_cache(cfg_t, B, cache_len, CPU)
    caches_r = {}
    for pfx, g, mixer, fk in t_stack._layers(cfg_t):
        p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
        run = jax.jit(lambda p, x, pfx=pfx, mixer=mixer, fk=fk: r_stack._prefill_layer(
            cfg_r, p, pfx, mixer, fk, x, jnp.asarray(positions), cache_len))
        y_r, caches_r[pfx] = run(p_r, x_r)
        views = t_stack._layer_cache(cache_t, pfx, g)
        y_t = t_stack._prefill_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                     interop.params_from_numpy({"x": np.asarray(x_r)})["x"],
                                     torch.from_numpy(positions.copy()), views, cache_len)
        _close(y_t.float().numpy(), y_r, f"{case} prefill {pfx} out", RECURRENT_TOL)
        for name, ref in _leaves(caches_r[pfx]):
            got = dict(_leaves(views))[name]
            assert got.dtype == _leaf_dtype(name), name
            _close(got.float().numpy(), ref, f"{case} prefill {pfx} cache {name}", RECURRENT_TOL)
        x_r = y_r
    xn = r_layers.rmsnorm(x_r, jnp.asarray(weights["final_ln"]))
    head = jnp.asarray(weights["lm_head"] if "lm_head" in weights else weights["embed"].T)
    lg_r = xn[:, -1] @ head.astype(xn.dtype)
    x_t = interop.params_from_numpy({"x": np.asarray(x_r)})["x"]
    lg_t = t_stack._head(p_t, t_layers.rmsnorm(x_t, p_t["final_ln"])[:, -1])
    _close(lg_t.float().numpy(), lg_r, f"{case} prefill logits", RECURRENT_TOL)
    for t in (S, S + 1):
        pos = np.full(B, t, np.int32)
        x_r = r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(toks[:, t]))[:, None]
        for pfx, g, mixer, fk in t_stack._layers(cfg_t):
            p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
            run = jax.jit(lambda p, x, c, pfx=pfx, mixer=mixer, fk=fk: r_stack._decode_layer(
                cfg_r, p, pfx, mixer, fk, x, jnp.asarray(pos), c))
            views = t_stack._layer_cache(cache_t, pfx, g)
            for (_, dst), (_, src) in zip(_leaves(views), _leaves(caches_r[pfx])):
                dst.copy_(interop.cache_from_numpy({"x": np.asarray(src)})["x"])
            y_r, caches_r[pfx] = run(p_r, x_r, caches_r[pfx])
            y_t = t_stack._decode_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                        interop.params_from_numpy({"x": np.asarray(x_r)})["x"],
                                        torch.from_numpy(pos), views)
            _close(y_t.float().numpy(), y_r, f"{case} decode {t} {pfx} out", RECURRENT_TOL)
            for name, ref in _leaves(caches_r[pfx]):
                _close(dict(_leaves(views))[name].float().numpy(), ref,
                       f"{case} decode {t} {pfx} cache {name}", RECURRENT_TOL)
            x_r = y_r


# The MoE stacks layer by layer. A routing decision is a discontinuous
# function of the bf16 activations: where two experts' gates nearly tie, an
# ulp of difference in the layer's attention output (the port's kernels keep
# P in float32 where the reference rounds it to bf16) picks the other expert.
# So in bf16 each layer runs on the reference's input, the routing of both
# sides is read, every token whose routing differs must be such a near tie
# or a capacity shift after one (`routelog.compare`), and the
# layer's output is held at 0.05 on the tokens whose routing agrees (the
# chip phase's rule); in float32 the stack runs free and the routing must be
# equal on every layer. llama4-scout-ring is held only here: its bf16 stack
# flips one top-1 decision (a near tie) and the flipped token moves the
# last position's prefill logits past the 0.05 limit of STACK_CASES.
MOE_CASES = {
    "mixtral-8x7b-ring": STACK_CASES["mixtral-8x7b-ring"],
    "mixtral-8x7b-drops": STACK_CASES["mixtral-8x7b-drops"],
    "llama4-scout-ring": ("llama4-scout-17b-a16e", dict(window=24), 40, 48),
    "llama4-scout-drops": STACK_CASES["llama4-scout-drops"],
}
@pytest.fixture
def route_log():
    """`routelog.RouteLog` installed for one test: the port's routing
    (moe_route's results), layer by layer."""
    with routelog.RouteLog() as log:
        yield log


def _pop_route(log):
    """The routing of the one MoE layer just run (`layers.Routing`)."""
    route = log.calls.pop()
    assert not log.calls
    return route


def _reference_ffn_input(cfg, p, pfx, mixer, x, positions=None, pos=None, cache=None):
    """The reference layer's FFN input (prefill: `positions`; decode: `pos`
    and the layer's cache), from its own functions."""
    from repro.models import attention as r_attn

    xn = r_layers.rmsnorm(x, p[f"{pfx}.mix.ln"])
    if cache is None:
        y, _ = r_attn.gqa_attn(cfg, p, pfx + ".mix", xn, positions, mixer=mixer)
    else:
        y, _ = r_attn.gqa_decode(cfg, p, pfx + ".mix", xn, pos, cache, mixer=mixer)
    return r_layers.rmsnorm(x + y, p[f"{pfx}.ffn.ln2"])


def _hold_routed(label, y_t, y_r, route_t, route_r, tol):
    """Hold y on the tokens whose routing agrees; every token whose routing
    differs must be explained by `routelog.compare`'s rules (a near tie of
    the reference's gates, or a kept / dropped shift after such a flip).
    Returns (decisions, differing tokens)."""
    ref = tuple(torch.from_numpy(np.array(a)) for a in route_r)
    agree = routelog.compare(ref, (route_t.topi, route_t.kept), label)[0].numpy()
    _close(y_t.float().numpy()[agree], np.asarray(y_r, np.float32)[agree], label, tol)
    return agree.size, int((~agree).sum())


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layers_match_reference_on_its_own_inputs(case, route_log):
    """Each layer of the port's bf16 MoE stack, prefill then two decode
    steps, on the reference's input (and, decoding, its cache): routing
    read on both sides, differing tokens near ties and at most
    routelog.MAX_FLIPS of the decisions, outputs of the agreeing tokens and
    every cache leaf within 0.05."""
    from test_torch_moe import reference_routing

    cfg_r, cfg_t, S, cache_len = _cfgs(case, MOE_CASES)
    weights = _weights(cfg_r)
    p_t = t_stack.cast_weights(cfg_t, interop.params_from_numpy(weights, CPU))
    B = 2
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)
    positions = jnp.asarray(np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)))
    x_r = r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(toks[:, :S]))
    cache_t = t_stack.init_cache(cfg_t, B, cache_len, CPU)
    caches_r, n, flips = {}, 0, 0
    route = jax.jit(lambda p, h, pfx: reference_routing(cfg_r, p, h, pfx + ".ffn"),
                    static_argnums=2)
    for pfx, g, mixer, fk in t_stack._layers(cfg_t):
        p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
        y_r, caches_r[pfx] = jax.jit(lambda p, x, pfx=pfx, mixer=mixer, fk=fk:
                                     r_stack._prefill_layer(cfg_r, p, pfx, mixer, fk, x,
                                                            positions, cache_len))(p_r, x_r)
        h_r = jax.jit(lambda p, x, pfx=pfx, mixer=mixer: _reference_ffn_input(
            cfg_r, p, pfx, mixer, x, positions=positions))(p_r, x_r)
        views = t_stack._layer_cache(cache_t, pfx, g)
        y_t = t_stack._prefill_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                     interop.params_from_numpy({"x": np.asarray(x_r)})["x"],
                                     torch.from_numpy(np.asarray(positions).copy()), views,
                                     cache_len)
        d = _hold_routed(f"{case} prefill {pfx}", y_t, y_r, _pop_route(route_log),
                         route(p_r, h_r, pfx), LOGIT_TOL)
        n, flips = n + d[0], flips + d[1]
        for name, ref in _leaves(caches_r[pfx]):
            _close(dict(_leaves(views))[name].float().numpy(), ref,
                   f"{case} prefill {pfx} cache {name}")
        x_r = y_r
    for t in (S, S + 1):
        pos = jnp.full((B,), t, jnp.int32)
        x_r = r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(toks[:, t]))[:, None]
        for pfx, g, mixer, fk in t_stack._layers(cfg_t):
            p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
            views = t_stack._layer_cache(cache_t, pfx, g)
            for (_, dst), (_, src) in zip(_leaves(views), _leaves(caches_r[pfx])):
                dst.copy_(interop.cache_from_numpy({"x": np.asarray(src)})["x"])
            h_r = jax.jit(lambda p, x, c, pfx=pfx, mixer=mixer: _reference_ffn_input(
                cfg_r, p, pfx, mixer, x, pos=pos, cache=c))(p_r, x_r, caches_r[pfx])
            y_r, caches_r[pfx] = jax.jit(lambda p, x, c, pfx=pfx, mixer=mixer, fk=fk:
                                         r_stack._decode_layer(cfg_r, p, pfx, mixer, fk, x, pos,
                                                               c))(p_r, x_r, caches_r[pfx])
            y_t = t_stack._decode_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                        interop.params_from_numpy({"x": np.asarray(x_r)})["x"],
                                        torch.from_numpy(np.array(pos)), views)
            d = _hold_routed(f"{case} decode {t} {pfx}", y_t, y_r, _pop_route(route_log),
                             route(p_r, h_r, pfx), LOGIT_TOL)
            n, flips = n + d[0], flips + d[1]
            for name, ref in _leaves(caches_r[pfx]):
                _close(dict(_leaves(views))[name].float().numpy(), ref,
                       f"{case} decode {t} {pfx} cache {name}")
            x_r = y_r
    print(f"{case}: {flips} of {n} routing decisions differ (near ties)")
    assert flips <= routelog.MAX_FLIPS * n, (flips, n)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_stack_free_running_in_float32_matches_reference(case, route_log):
    """The whole reduced MoE stack free-running in float32 activations and
    weights, prefill then two decode steps each on its own cache: the
    routing (experts and kept assignments) equal on every layer, every
    layer's output within 1e-4 abs + rel."""
    from test_torch_moe import reference_routing

    cfg_r, cfg_t, S, cache_len = _cfgs(case, MOE_CASES)
    weights = _weights(cfg_r)
    p_t = interop.params_from_numpy(weights, CPU)  # float32: no bf16 copies
    B, tol = 2, 1e-4
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))

    def embed(ids):
        return (r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(ids), jnp.float32),
                t_layers.embed_lookup(p_t["embed"], torch.from_numpy(ids), torch.float32))

    def check(label, p_r, pfx, h_r):
        topi_r, kept_r, _ = reference_routing(cfg_r, p_r, h_r, pfx + ".ffn")
        route = _pop_route(route_log)
        np.testing.assert_array_equal(route.topi.numpy(), np.asarray(topi_r), err_msg=label)
        np.testing.assert_array_equal(route.kept.numpy(), np.asarray(kept_r), err_msg=label)

    x_r, x_t = embed(toks[:, :S])
    # K/V in float32 as well, as the reference's float32 prefill pads them
    cache_t = {blk: {n: x.float() for n, x in c.items()}
               for blk, c in t_stack.init_cache(cfg_t, B, cache_len, CPU).items()}
    caches_r = {}
    for pfx, g, mixer, fk in t_stack._layers(cfg_t):
        p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
        h_r = _reference_ffn_input(cfg_r, p_r, pfx, mixer, x_r, positions=jnp.asarray(positions))
        x_r, caches_r[pfx] = r_stack._prefill_layer(cfg_r, p_r, pfx, mixer, fk, x_r,
                                                    jnp.asarray(positions), cache_len)
        x_t = t_stack._prefill_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk, x_t,
                                     torch.from_numpy(positions.copy()),
                                     t_stack._layer_cache(cache_t, pfx, g), cache_len)
        check(f"{case} prefill {pfx} routing", p_r, pfx, h_r)
        _close(x_t.numpy(), x_r, f"{case} prefill {pfx} out", tol)
    for t in (S, S + 1):
        pos = np.full(B, t, np.int32)
        x_r, x_t = embed(toks[:, t])
        x_r, x_t = x_r[:, None], x_t[:, None]
        for pfx, g, mixer, fk in t_stack._layers(cfg_t):
            p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
            h_r = _reference_ffn_input(cfg_r, p_r, pfx, mixer, x_r, pos=jnp.asarray(pos),
                                       cache=caches_r[pfx])
            x_r, caches_r[pfx] = r_stack._decode_layer(cfg_r, p_r, pfx, mixer, fk, x_r,
                                                       jnp.asarray(pos), caches_r[pfx])
            x_t = t_stack._decode_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                        x_t, torch.from_numpy(pos),
                                        t_stack._layer_cache(cache_t, pfx, g))
            check(f"{case} decode {t} {pfx} routing", p_r, pfx, h_r)
            _close(x_t.numpy(), x_r, f"{case} decode {t} {pfx} out", tol)


def test_xlstm_stack_free_running_in_float32_matches_reference():
    """The whole reduced xLSTM stack (7 mLSTM + 1 sLSTM) free-running in
    float32 activations and weights, prefill then two decode steps each on
    its own cache: every layer's output and state within 1e-4 abs + rel
    (float32 math in another order, amplified over 8 layers)."""
    cfg_r, cfg_t = r_registry.reduced("xlstm-350m"), t_registry.reduced("xlstm-350m")
    weights = _weights(cfg_r)
    p_t = interop.params_from_numpy(weights, CPU)  # float32: no bf16 copies
    B, S, tol = 2, 40, 1e-4
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab, (B, S + 2)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    x_r = r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(toks[:, :S]),
                                jnp.float32)
    x_t = t_layers.embed_lookup(p_t["embed"], torch.from_numpy(toks[:, :S]), torch.float32)
    cache_t = t_stack.init_cache(cfg_t, B, 48, CPU)
    caches_r = {}
    for pfx, g, mixer, fk in t_stack._layers(cfg_t):
        p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
        x_r, caches_r[pfx] = r_stack._prefill_layer(cfg_r, p_r, pfx, mixer, fk, x_r,
                                                    jnp.asarray(positions), 48)
        views = t_stack._layer_cache(cache_t, pfx, g)
        x_t = t_stack._prefill_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk, x_t,
                                     torch.from_numpy(positions.copy()), views, 48)
        _close(x_t.numpy(), x_r, f"prefill {pfx} out", tol)
        for name, ref in _leaves(caches_r[pfx]):
            if name != "conv":  # the cache keeps the conv window in bf16
                _close(dict(_leaves(views))[name].numpy(), ref, f"prefill {pfx} {name}", tol)
    for t in (S, S + 1):
        pos = np.full(B, t, np.int32)
        x_r = r_layers.embed_lookup(jnp.asarray(weights["embed"]), jnp.asarray(toks[:, t]),
                                    jnp.float32)[:, None]
        x_t = t_layers.embed_lookup(p_t["embed"], torch.from_numpy(toks[:, t]),
                                    torch.float32)[:, None]
        for pfx, g, mixer, fk in t_stack._layers(cfg_t):
            p_r = {k: jnp.asarray(v) for k, v in _layer_params(weights, pfx, g).items()}
            views = t_stack._layer_cache(cache_t, pfx, g)
            if mixer == "mlstm":  # the port's conv window is bf16: hand the reference the same
                caches_r[pfx]["conv"] = jnp.asarray(views["conv"].float().numpy())
            x_r, caches_r[pfx] = r_stack._decode_layer(cfg_r, p_r, pfx, mixer, fk, x_r,
                                                       jnp.asarray(pos), caches_r[pfx])
            x_t = t_stack._decode_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                        x_t, torch.from_numpy(pos), views)
            _close(x_t.numpy(), x_r, f"decode {t} {pfx} out", tol)


def test_cast_weights_are_bitwise_a_per_call_cast():
    cfg = dataclasses.replace(t_registry.reduced("qwen2-72b"), n_layers=1)
    p = t_init_params(t_stack.build_schema(cfg), torch.Generator().manual_seed(1), CPU)
    for k in p:
        if k.endswith((".ln", ".ln2", "final_ln", ".bq", ".bk", ".bv")):
            p[k] = p[k] + 0.1
    cast = t_stack.cast_weights(cfg, p)
    assert t_stack.ACT_DTYPE == torch.bfloat16  # the reference's activations
    assert cast["embed"].dtype == torch.bfloat16 and cast["blk0.mix.wq"].dtype == torch.bfloat16
    assert cast["blk0.mix.ln"] is p["blk0.mix.ln"] and cast["final_ln"].dtype == torch.float32
    toks = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(2))}
    a, ca = t_stack.forward_prefill(cfg, p, toks, 16)
    b, cb = t_stack.forward_prefill(cfg, cast, toks, 16)
    assert torch.equal(a, b) and torch.equal(ca["blk0"]["k"], cb["blk0"]["k"])


def test_cast_weights_decides_per_mixer():
    """rglru's gate weights stay float32 (the reference's bf16 x float32
    einsum promotes to float32), while mlstm's same-named `wi` / `bi` cast
    to bf16; slstm's recurrent `r` stays float32."""
    bf16, f32 = torch.bfloat16, torch.float32
    for arch, keep, cast in [
        ("recurrentgemma-9b",
         ["blk0.mix.wa", "blk0.mix.wi", "blk0.mix.ba", "blk0.mix.bi", "blk0.mix.lam",
          "tail0.mix.wi", "blk0.mix.ln", "blk2.ffn.ln2"],
         ["blk0.mix.wgate", "blk0.mix.wx", "blk0.mix.conv", "blk0.mix.wout", "blk2.mix.wq",
          "blk2.mix.wo", "blk0.ffn.wg", "tail1.ffn.wd", "embed"]),
        ("xlstm-350m",
         ["blk3.mix.r", "blk0.mix.ln", "blk0.mix.mn", "blk3.mix.mn"],
         ["blk0.mix.wi", "blk0.mix.bi", "blk0.mix.wf", "blk0.mix.bf", "blk0.mix.conv",
          "blk0.mix.wu", "blk0.mix.wq", "blk3.mix.wzifo", "blk3.mix.bzifo", "blk3.mix.wd",
          "embed"]),
    ]:
        cfg = t_registry.reduced(arch)
        p = t_init_params(t_stack.build_schema(cfg), torch.Generator().manual_seed(1), CPU)
        out = t_stack.cast_weights(cfg, p)
        assert set(out) == set(p)
        for name in keep:
            assert out[name] is p[name] and out[name].dtype == f32, (arch, name)
        for name in cast:
            assert out[name].dtype == bf16 and torch.equal(out[name], p[name].to(bf16)), name


@pytest.mark.parametrize(
    "arch,changes,item",
    [
        ("seamless-m4t-large-v2", {}, "A9"),  # encoder-decoder + audio frontend
        ("internvl2-26b", {}, "A9"),  # vision frontend
        ("llama3.2-3b", {"kv_cache_dtype": "int8"}, "A9"),
    ],
)
def test_unported_mixers_and_options_raise(arch, changes, item):
    """The paths of ROADMAP §A item A9 (the encoder-decoder, the vision
    frontend, the int8 KV cache) are ported: no entry point raises for them
    and no source of the port cites the item any more; a KV cache dtype or
    frontend the model family does not have raises ValueError."""
    cfg = dataclasses.replace(t_registry.reduced(arch), **changes)
    t_stack.check_supported(cfg)
    cache = t_stack.init_cache(cfg, 1, 8, CPU)
    assert all(not x.any() for _, x in _leaves(cache))
    for bad, msg in (({"kv_cache_dtype": "fp8"}, "KV cache dtype"),
                     ({"frontend": "video"}, "frontend")):
        with pytest.raises(ValueError, match=msg):
            t_stack.check_supported(dataclasses.replace(cfg, **bad))
    src = pathlib.Path(t_stack.__file__).resolve().parents[1]
    cites = [f for f in src.rglob("*.py") if f'"{item}"' in f.read_text()]
    assert not cites, cites


@pytest.mark.parametrize("arch", ARCHS)
def test_every_registry_config_serves(arch):
    """`check_supported` passes for every registry config, and its reduced
    form runs a prefill and a decode step on the CPU with finite logits."""
    t_stack.check_supported(t_registry.get(arch))
    cfg = t_registry.reduced(arch)
    params = t_stack.cast_weights(
        cfg, t_init_params(t_stack.build_schema(cfg), torch.Generator().manual_seed(0), CPU))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32))
    if cfg.is_encdec:
        batch = {"frames": torch.randn((2, 6, cfg.frontend_dim)), "dec_tokens": toks[:, :8]}
    elif cfg.frontend == "vision":
        batch = {"patches": torch.randn((2, 3, cfg.frontend_dim)), "tokens": toks[:, :8]}
    else:
        batch = {"tokens": toks[:, :8]}
    S = 8 + (3 if cfg.frontend == "vision" else 0)
    logits, cache = t_model.make_prefill_step(cfg, 16)(params, batch)
    step, _ = t_model.make_decode_step(cfg)(params, toks[:, 8], torch.full((2,), S), cache)
    assert logits.shape == step.shape == (2, cfg.vocab)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(step.float()).all()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e", "minicpm3-4b"])
def test_moe_and_mla_configs_are_supported(arch):
    for cfg in (t_registry.get(arch), t_registry.reduced(arch)):
        t_stack.check_supported(cfg)
    cache = t_stack.init_cache(t_registry.reduced(arch), 2, 8, CPU)
    assert all(not x.any() for _, x in _leaves(cache))


def test_irope_skips_rope_on_llama4_global_layers_only():
    """iRoPE as a config property: llama4's `gqa` layers take no RoPE, its
    `cla` layers and every other model's `gqa` layers do. A prefill on
    shifted positions changes q and k exactly where RoPE applies."""
    from repro_torch.models import attention as t_attn

    rng = np.random.default_rng(3)
    for arch, mixer, rope in [("llama4-scout-17b-a16e", "gqa", False),
                              ("llama4-scout-17b-a16e", "cla", True),
                              ("llama3.2-3b", "gqa", True)]:
        cfg = t_registry.reduced(arch)
        assert t_attn.use_rope(cfg, mixer) == rope
        w = {f"m.{n}": torch.from_numpy(0.1 * rng.standard_normal(s, np.float32))
             for n, s in (("wq", (cfg.d_model, cfg.n_heads, cfg.hd)),
                          ("wk", (cfg.d_model, cfg.n_kv_heads, cfg.hd)),
                          ("wv", (cfg.d_model, cfg.n_kv_heads, cfg.hd)))}
        x = torch.from_numpy(rng.standard_normal((1, 5, cfg.d_model), np.float32))
        pos = torch.arange(5, dtype=torch.int32)[None]
        q0, k0, _ = t_attn.gqa_project_qkv(cfg, w, "m", x, pos, t_attn.use_rope(cfg, mixer))
        q1, k1, _ = t_attn.gqa_project_qkv(cfg, w, "m", x, pos + 7, t_attn.use_rope(cfg, mixer))
        assert torch.equal(q0, q1) == (not rope) and torch.equal(k0, k1) == (not rope), arch


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e", "minicpm3-4b"])
def test_interop_carries_moe_and_mla_leaves(arch):
    """The reference's MoE / MLA parameters and its MLA cache cross as they
    are: every name, shape and value (bf16 cache leaves bit for bit), and
    back."""
    cfg_r = r_registry.reduced(arch)
    weights = _weights(cfg_r)
    p_t = interop.params_from_numpy(weights, CPU)
    assert set(p_t) == set(weights)
    for name, x in weights.items():
        assert p_t[name].dtype == torch.float32 and np.array_equal(p_t[name].numpy(), x), name
    toks = np.random.default_rng(1).integers(0, cfg_r.vocab, (2, 12)).astype(np.int32)
    _, cache_r = r_stack.forward_prefill(cfg_r, {k: jnp.asarray(v) for k, v in weights.items()},
                                         {"tokens": jnp.asarray(toks)}, 16)
    cache_t = interop.cache_from_numpy(jax.tree.map(np.asarray, cache_r), CPU)
    back = dict(_leaves(interop.cache_to_numpy(cache_t)))
    for name, ref in _leaves(cache_r):
        assert dict(_leaves(cache_t))[name].dtype == _leaf_dtype(name), name
        assert np.array_equal(back[name], np.asarray(ref, np.float32)), name


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_registry.reduced("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_stack.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_init_params(t_stack.build_schema(cfg), torch.Generator())
