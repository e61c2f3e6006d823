"""The port's MoE FFN (`repro_torch.models.layers.moe_ffn` / `moe_route`)
against the reference's `repro.models.layers.moe_ffn`, on seeded numpy
inputs at reduced width: 4 and 8 experts, top-1 and top-2, float32 and
bf16, with no drops (capacity factor 8.0), with drops (1.0 and 0.5), with
two experts whose logits tie exactly, and at decode's S = 1.

The reference returns only the FFN's output; its routing (expert indices
and the kept / dropped assignments) is read with `reference_routing`, the
first lines of its `moe_ffn` verbatim, run under `jax.jit` as the stack
runs them.

Tolerances: in float32 the routing is equal and the output within 1e-5
abs + rel (the expert products and the combine sum in another order). In
bf16 the routing is equal too (the router logits are the same bf16
product) and the output within 2**-6 abs + rel: the combine weights are
the float32 gates rounded to bf16, and a gate one float32 ulp apart can
round to the neighbouring bf16 value, moving a token's output by one bf16
ulp (2**-8 relative) of that expert's share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import layers as r_layers
from repro_torch.configs import registry as t_registry
from repro_torch.models import layers as t_layers
from repro_torch.models import routelog
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2**-6}
D, F = 32, 48


def _cfgs(E, K, cf):
    changes = dict(n_experts=E, top_k=K, capacity_factor=cf, d_model=D, d_ff=F)
    return (dataclasses.replace(r_registry.reduced("mixtral-8x7b"), **changes),
            dataclasses.replace(t_registry.reduced("mixtral-8x7b"), **changes))


def _inputs(E, B, S, seed, tie=None):
    """x [B,S,D] and the FFN's weights; `tie` = (i, j): router columns i
    and j equal and the others scaled down, so the two experts tie exactly
    at the top for every token with a positive logit there (about half)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = {"f.router": rng.standard_normal((D, E)).astype(np.float32) * D**-0.5,
         "f.we_g": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
         "f.we_u": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
         "f.we_d": rng.standard_normal((E, F, D)).astype(np.float32) * F**-0.5}
    if tie is not None:
        w["f.router"] *= 0.1
        col = rng.standard_normal(D).astype(np.float32) * D**-0.5
        w["f.router"][:, tie[0]] = w["f.router"][:, tie[1]] = col
    return x, w


def reference_routing(cfg, p, x, prefix="f"):
    """(topi, kept, gates): [B,S,K] experts and kept assignments and the
    [B,S,E] float32 gates, as the reference's `moe_ffn` computes them."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * K * B * S / (E * max(B, 1))), 1)
    logits = jnp.einsum("bsd,de->bse", x, p[f"{prefix}.router"].astype(x.dtype))
    gates = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(gates, K)
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(B, S * K, E), axis=1).reshape(B, S, K, E) - onehot
    return topi, jnp.sum(pos * onehot, -1) < cap, gates


def _run(E, K, cf, dtype, B, S, seed, tie=None):
    cfg_r, cfg_t = _cfgs(E, K, cf)
    jdt, tdt = DTYPES[dtype]
    x, w = _inputs(E, B, S, seed, tie)
    p_r = {k: jnp.asarray(v) for k, v in w.items()}
    p_t = {k: torch.from_numpy(v) for k, v in w.items()}
    x_r, x_t = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    ref = jax.jit(lambda p, x: r_layers.moe_ffn(cfg_r, p, "f", x))(p_r, x_r)
    topi_r, kept_r, gates_r = jax.jit(lambda p, x: reference_routing(cfg_r, p, x))(p_r, x_r)
    out = t_layers.moe_ffn(cfg_t, p_t, "f", x_t)
    topi, _, _, kept, gates = t_layers.moe_route(cfg_t, p_t, "f", x_t)
    assert out.dtype == tdt and out.shape == x_t.shape
    np.testing.assert_array_equal(topi.numpy(), np.asarray(topi_r))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    return topi.numpy(), kept.numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,K", [(4, 1), (4, 2), (8, 1), (8, 2)])
def test_moe_without_drops_matches_reference(E, K, dtype):
    _, kept = _run(E, K, 8.0, dtype, B=2, S=24, seed=E + K)
    assert kept.all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cf", [1.0, 0.5])
@pytest.mark.parametrize("E,K", [(4, 1), (4, 2), (8, 1), (8, 2)])
def test_moe_drops_the_reference_assignments(E, K, cf, dtype):
    """Past the capacity an assignment contributes zero; the port drops the
    same (b, s, k) set as the reference (asserted equal in `_run`)."""
    _, kept = _run(E, K, cf, dtype, B=2, S=24, seed=10 * E + K)
    assert (~kept).sum() >= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K", [1, 2])
def test_moe_breaks_exact_ties_as_the_reference(K, dtype):
    """Experts 1 and 3 have equal router columns: their logits tie exactly
    and top the gates for about half the tokens. `jax.lax.top_k` takes the
    lower index first; so does the port's stable descending sort."""
    topi, _ = _run(4, K, 8.0, dtype, B=2, S=24, seed=7, tie=(1, 3))
    first = topi[..., 0]
    assert (first == 1).sum() >= 12 and not (first == 3).any()
    if K == 2:
        assert ((topi[..., 1] == 3) == (first == 1)).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,K", [(4, 1), (8, 2)])
def test_moe_decode_shape(E, K, dtype):
    """S = 1, as each decode step calls it: one slot per expert and row."""
    _, kept = _run(E, K, 1.25, dtype, B=4, S=1, seed=3)
    assert kept.all()


def _routes(ref_experts, other_experts, ref_kept, other_kept, gates):
    """One batch row of top-1 routings over three experts, as CPU tensors."""
    t = lambda a, dt=torch.int64: torch.tensor(a, dtype=dt)[None, :, None]  # noqa: E731
    return ((t(ref_experts), t(ref_kept, torch.bool), torch.tensor(gates)[None]),
            (t(other_experts), t(other_kept, torch.bool)))


GATES = [[0.40, 0.39, 0.21], [0.7, 0.2, 0.1], [0.6, 0.3, 0.1]]


@pytest.mark.parametrize("name,other_experts,other_kept,want", [
    ("equal", [0, 0, 0], [True, True, False], (3, 0, 0)),
    # token 0 flips at a near tie; token 2's slot in expert 0 moves up a place
    # and is kept: a kept-only difference that the flip explains
    ("flip at a tie, then a capacity shift", [1, 0, 0], [True, True, True], (1, 1, 1)),
    ("flip off a tie", [0, 2, 0], [True, True, False], "off a tie"),
    ("kept-only difference with no flip before it", [0, 0, 0], [True, False, False],
     "no earlier flip"),
])
def test_routelog_compare_explains_each_difference(name, other_experts, other_kept, want):
    """`routelog.compare`, the rule the chip phases and the MoE stack tests
    hold routings by: equal tokens agree; an expert flip must be a near tie
    of the reference's gates; a kept / dropped difference alone must follow
    a flip in its row that moved an assignment to or from that expert."""
    ref, other = _routes([0, 0, 0], other_experts, [True, True, False], other_kept, GATES)
    if isinstance(want, str):
        with pytest.raises(AssertionError, match=want):
            routelog.compare(ref, other, name)
        return
    agree, flips, kept_only = routelog.compare(ref, other, name)
    assert (int(agree.sum()), flips, kept_only) == want


def test_route_log_records_routing_and_drops():
    """`routelog.RouteLog` records moe_route's results while installed and
    puts the real function back; `dropped` counts the assignments past the
    capacity."""
    cfg_r, cfg_t = _cfgs(4, 2, 0.5)
    x, w = _inputs(4, 2, 24, seed=3)
    real = t_layers.moe_route
    with routelog.RouteLog() as log:
        t_layers.moe_ffn(cfg_t, {k: torch.from_numpy(v) for k, v in w.items()}, "f",
                         torch.from_numpy(x))
    assert t_layers.moe_route is real and len(log.calls) == 1
    route = log.calls[0]
    assert route.gates.shape == (2, 24, 4) and log.dropped() == int((~route.kept).sum()) > 0
