"""The backward of the recurrent kernels' functions against the reference:
the plain backwards `mlstm_bwd_ref` and `rglru_bwd_ref` (the CPU route of
the port's B5 / B4 backward kernels, and what chip_smoke.py holds those
kernels against), the differentiable wrappers `ops.mlstm` / `ops.rglru` /
`ops.rglru_scan`, and the mLSTM and RG-LRU blocks and a reduced train
step through them.

The JAX package has no backward kernel: it differentiates its plain
functions, so the gradients are held against `jax.vjp` of
`repro.kernels.mlstm.ref.mlstm_ref`, `repro.models.xlstm.mlstm_parallel`
(its query chunks: S <= 512 or chunks that divide S, C4),
`repro.kernels.rglru.ref.rglru_ref` (with and without h0; with b's
formation composed in front for the op) and `repro.models.rglru.rglru_scan`
(the associative scan, b's formation included).

Tolerances:
- float32 inputs: 1e-4 abs + rel (float32 sums in another order, and
  `jax.grad`'s path through the max that sets the stabiliser m, whose exact
  gradient is zero);
- bf16 heads (float32 math): each gradient within 2e-2 relative L2 (the
  plain backward reads the forward's h rounded to bf16 for δ = dh · h and
  rounds dq / dk / dv to bf16; the reference keeps them in float32 inside);
- against `torch.autograd.grad` through the port's plain forwards: 1e-4
  abs + rel in float32 too (the same math, explicit formulas against
  autograd; a row whose normaliser |σ_i|, a cancelling signed sum, sits
  near exp(-m_i) conditions the gradient: row 28 of the first case, at
  1.0115 exp(-m_i), differs by ~3e-4 of its largest entry);
- the RG-LRU's log_a is drawn in the model's range, -8 softplus(lam) r with
  lam about its init of ones and r = sigmoid(N(0, 2)), so a reaches ~0.996
  where -a² / sqrt(1 - a²) grows: 1e-4 abs + rel there too;
- the blocks in float32: 1e-4 abs + rel; a reduced train step of each
  family: the loss in bf16 within 2e-3 of the reference's (the llama
  step's limit in tests/test_torch_train.py), every gradient leaf within
  1e-4 relative L2 of autograd through the plain forwards (xLSTM with
  float32 activations, see the test); remat "full" / "dots" on reduced
  xlstm-350m bit for bit the plain backward.
The test inputs keep clear of the normaliser's tie |σ_i| = exp(-m_i),
where `jax.grad` splits the gradient between the two branches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.kernels.mlstm.ref import mlstm_ref as r_mlstm_ref
from repro.kernels.rglru.ref import rglru_ref as r_rglru_ref
from repro.models import model as r_model
from repro.models import rglru as r_rglru
from repro.models import stack as r_stack
from repro.models import xlstm as r_xlstm
from repro.models.schema import init_params as r_init_params
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.kernels.mlstm import ops as m_ops
from repro_torch.kernels.mlstm.ref import mlstm_bwd_ref, mlstm_ref
from repro_torch.kernels.rglru import ops as r_ops
from repro_torch.kernels.rglru.ref import gated_input, rglru_bwd_ref, rglru_ref
from repro_torch.models import model as t_model
from repro_torch.models import rglru as t_rglru
from repro_torch.models import stack as t_stack
from repro_torch.models import xlstm as t_xlstm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL, BF16_RL2 = 1e-4, 2e-2
MLSTM_NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")

# (B, H, S, dh): S below and above one 64-row tile, ragged S and dh
MLSTM_CASES = [(2, 2, 64, 32), (1, 3, 100, 16), (1, 1, 256, 8)]
# (B, H, S, dh, q_chunk) of `mlstm_parallel`: one chunk, and chunks that divide S
MLSTM_PARALLEL_CASES = [(1, 2, 96, 16, 512), (2, 1, 96, 16, 32)]
RGLRU_CASES = [(2, 64, 16), (1, 130, 24), (3, 7, 5)]  # (B, S, E)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _hold(got, want, dtype, label):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL, err_msg=label)
    else:
        assert _rel_l2(got, want) <= BF16_RL2, (label, _rel_l2(got, want))


def _mlstm_inputs(case, seed):
    """The reference kernel test's distribution: q, k, v ~ N(0, 1), logi ~
    N(0, 0.25), logf = log sigmoid(N(2, 1)), and dh ~ N(0, 1), as numpy
    float32."""
    B, H, S, dh = case
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, S, dh)).astype(np.float32) for _ in range(4))
    logi = (0.5 * rng.standard_normal((B, H, S))).astype(np.float32)
    logf = -np.logaddexp(0.0, -(rng.standard_normal((B, H, S)) + 2.0)).astype(np.float32)
    return q, k, v, logi, logf, g


def _port_mlstm_bwd(q, k, v, logi, logf, g, dtype):
    """`mlstm_bwd_ref` on the port's tensors in `dtype`, given the plain
    forward's row statistics m and n as the wrapper passes them, dlogf
    formed from dF as the wrapper forms it."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    qt, kt, vt, gt = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    li, lf = torch.from_numpy(logi), torch.from_numpy(logf)
    F = torch.cumsum(lf, dim=-1)
    h, m, n = mlstm_ref(qt, kt, vt, li, lf, with_stats=True)
    dq, dk, dv, dlogi, dF = mlstm_bwd_ref(qt, kt, vt, li, F, h, gt, m, n)
    return dq, dk, dv, dlogi, torch.flip(torch.cumsum(torch.flip(dF, (-1,)), dim=-1), (-1,))


def _jax_vjp(fn, args, cotangent):
    """`jax.vjp` of fn at args, pulled back from the cotangent (cast to the
    output's dtype), compiled."""

    def pull(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return vjp(ct.astype(out.dtype))

    return jax.jit(pull)(args, cotangent)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_bwd_ref_matches_jax_vjp_of_mlstm_ref(case, dtype):
    q, k, v, logi, logf, g = _mlstm_inputs(case, seed=sum(case))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref = _jax_vjp(r_mlstm_ref, [jnp.asarray(x, jdt) for x in (q, k, v)]
                   + [jnp.asarray(logi), jnp.asarray(logf)], jnp.asarray(g, jdt))
    got = _port_mlstm_bwd(q, k, v, logi, logf, g, dtype)
    for name, a, r in zip(MLSTM_NAMES, got, ref):
        _hold(a, np.asarray(r, np.float32), dtype, f"mlstm {case} {dtype} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLSTM_PARALLEL_CASES)
def test_mlstm_bwd_ref_matches_jax_vjp_of_mlstm_parallel(case, dtype):
    *shape, q_chunk = case
    q, k, v, logi, logf, g = _mlstm_inputs(tuple(shape), seed=7 + q_chunk)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    # the model's own gate sums are float32; its heads are the activations' dtype
    fn = lambda q_, k_, v_, i_, f_: r_xlstm.mlstm_parallel(q_, k_, v_, i_, f_, q_chunk=q_chunk)
    ref = _jax_vjp(fn, [jnp.asarray(x, jdt) for x in (q, k, v)]
                   + [jnp.asarray(logi), jnp.asarray(logf)], jnp.asarray(g, jdt))
    got = _port_mlstm_bwd(q, k, v, logi, logf, g, dtype)
    for name, a, r in zip(MLSTM_NAMES, got, ref):
        _hold(a, np.asarray(r, np.float32), dtype, f"mlstm_parallel {case} {dtype} {name}")


def _rglru_inputs(case, seed, dtype="float32"):
    """log_a = -8 softplus(lam) r in the model's range, gx, h0 and dh ~
    N(0, 1), numpy float32 (gx and dh rounded to `dtype`)."""
    B, S, E = case
    rng = np.random.default_rng(seed)
    lam = 1.0 + 0.5 * rng.standard_normal(E)
    r = 1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, S, E))))
    log_a = (-8.0 * np.logaddexp(0.0, lam) * r).astype(np.float32)
    gx, dh = (rng.standard_normal((B, S, E)).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":
        gx, dh = (torch.from_numpy(x).bfloat16().float().numpy() for x in (gx, dh))
    return log_a, gx, rng.standard_normal((B, E)).astype(np.float32), dh


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_bwd_ref_matches_jax_vjp_of_rglru_ref(case, with_h0):
    log_a, gx, h0, dh = _rglru_inputs(case, seed=sum(case) + with_h0)
    b = gx  # the contract takes b as it is
    args = [jnp.asarray(log_a), jnp.asarray(b)] + ([jnp.asarray(h0)] if with_h0 else [])
    ref = _jax_vjp(r_rglru_ref, args, jnp.asarray(dh))
    la, bt, dht = (torch.from_numpy(x) for x in (log_a, b, dh))
    h0t = torch.from_numpy(h0) if with_h0 else None
    h = rglru_ref(la, bt, h0t)
    got = rglru_bwd_ref(la, bt, h, dht, h0=h0t)
    assert (got[2] is None) == (not with_h0)
    for name, a, r in zip(("dlog_a", "db", "dh0"), got, ref):
        _hold(a, np.asarray(r), "float32", f"rglru_ref {case} h0={with_h0} {name}")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_bwd_ref_fused_matches_jax_vjp_of_the_op(case, with_h0):
    """The op: b's formation composed in front of `rglru_ref` (from h0)."""
    log_a, gx, h0, dh = _rglru_inputs(case, seed=3 * sum(case) + with_h0)

    def op(la, g, *h):
        a = jnp.exp(la)
        return r_rglru_ref(la, jnp.sqrt(jnp.clip(1.0 - a * a, 0.0, 1.0)) * g, *h)

    args = [jnp.asarray(log_a), jnp.asarray(gx)] + ([jnp.asarray(h0)] if with_h0 else [])
    ref = _jax_vjp(op, args, jnp.asarray(dh))
    la, gt, dht = (torch.from_numpy(x) for x in (log_a, gx, dh))
    h0t = torch.from_numpy(h0) if with_h0 else None
    h = rglru_ref(la, gated_input(la, gt), h0t)
    got = rglru_bwd_ref(la, gt, h, dht, h0=h0t, fused=True)
    for name, a, r in zip(("dlog_a", "dgx", "dh0"), got, ref):
        _hold(a, np.asarray(r), "float32", f"rglru op {case} h0={with_h0} {name}")


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_bwd_ref_fused_matches_jax_vjp_of_the_model_scan(case):
    """`repro.models.rglru.rglru_scan`: the associative scan over b formed
    from gx."""
    log_a, gx, _, dh = _rglru_inputs(case, seed=5 * sum(case))
    ref = _jax_vjp(r_rglru.rglru_scan, [jnp.asarray(log_a), jnp.asarray(gx)], jnp.asarray(dh))
    la, gt, dht = (torch.from_numpy(x) for x in (log_a, gx, dh))
    got = rglru_bwd_ref(la, gt, rglru_ref(la, gated_input(la, gt)), dht, fused=True)
    for name, a, r in zip(("dlog_a", "dgx"), got, ref):
        _hold(a, np.asarray(r), "float32", f"rglru_scan {case} {name}")


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_bwd_ref_matches_autograd_of_the_plain_forward(case):
    q, k, v, logi, logf, g = (torch.from_numpy(x) for x in _mlstm_inputs(case, seed=11))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, logi, logf)]
    want = torch.autograd.grad(mlstm_ref(*leaves), leaves, g)
    got = _port_mlstm_bwd(*(x.numpy() for x in (q, k, v, logi, logf, g)), "float32")
    for name, a, r in zip(MLSTM_NAMES, got, want):
        torch.testing.assert_close(a, r, atol=F32_TOL, rtol=F32_TOL, msg=name)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_bwd_ref_matches_autograd_of_the_plain_forward(case, fused):
    log_a, gx, h0, dh = (torch.from_numpy(x) for x in _rglru_inputs(case, seed=13))
    leaves = [x.clone().requires_grad_(True) for x in (log_a, gx, h0)]
    b = gated_input(leaves[0], leaves[1]) if fused else leaves[1]
    h = rglru_ref(leaves[0], b, leaves[2])
    want = torch.autograd.grad(h, leaves, dh)
    got = rglru_bwd_ref(log_a, gx, h.detach(), dh, h0=h0, fused=fused)
    for name, a, r in zip(("dlog_a", "dx", "dh0"), got, want):
        torch.testing.assert_close(a, r, atol=F32_TOL, rtol=F32_TOL, msg=name)


# ---- the differentiable wrappers on the CPU ---------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_wrapper_is_the_function_with_the_plain_backward(dtype):
    """`ops.mlstm` with an input that needs a gradient runs `_Mlstm`: the
    forward equals the plain call bit for bit, the gradients equal
    `mlstm_bwd_ref` with dlogf the reverse cumsum of dF; no launch counted.
    Without a gradient the output has no history."""
    q, k, v, logi, logf, g = (torch.from_numpy(x) for x in _mlstm_inputs((2, 2, 37, 16), 17))
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    m_ops.reset_launches()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, logi, logf)]
    out = m_ops.mlstm(*leaves)
    assert isinstance(out.grad_fn, m_ops._Mlstm._backward_cls)
    assert torch.equal(out.detach(), mlstm_ref(q, k, v, logi, logf))
    grads = torch.autograd.grad(out, leaves, g)
    want = _port_mlstm_bwd(*(x.float().numpy() for x in (q, k, v, logi, logf, g)),
                           str(dtype)[6:])
    for name, a, r in zip(MLSTM_NAMES, grads, want):
        assert a.dtype == (dtype if name in ("dq", "dk", "dv") else torch.float32), name
        assert torch.equal(a, r), name
    assert (m_ops.mlstm.launches, m_ops.mlstm_bwd.launches) == (0, 0)
    assert m_ops.mlstm(q, k, v, logi, logf).grad_fn is None
    with torch.no_grad():
        assert m_ops.mlstm(*leaves).grad_fn is None


def test_rglru_wrappers_are_functions_with_the_plain_backward():
    log_a, gx, h0, dh = (torch.from_numpy(x) for x in _rglru_inputs((2, 33, 12), 19))
    for h0_ in (None, h0):
        leaves = [x.clone().requires_grad_(True) for x in (log_a, gx)]
        out = r_ops.rglru(*leaves, h0=h0_)
        assert isinstance(out.grad_fn, r_ops._Rglru._backward_cls)
        assert torch.equal(out.detach(), r_ops.rglru(log_a, gx, h0=h0_))
        got = torch.autograd.grad(out, leaves, dh)
        want = rglru_bwd_ref(log_a, gx, out.detach(), dh, h0=h0_, fused=True)
        assert all(torch.equal(a, r) for a, r in zip(got, want))
    b = gated_input(log_a, gx)
    leaves = [x.clone().requires_grad_(True) for x in (log_a, b)]
    out = r_ops.rglru_scan(*leaves)
    assert isinstance(out.grad_fn, r_ops._RglruScan._backward_cls)
    got = torch.autograd.grad(out, leaves, dh)
    want = rglru_bwd_ref(log_a, b, out.detach(), dh)
    assert all(torch.equal(a, r) for a, r in zip(got, want[:2]))
    assert r_ops.rglru_bwd.launches == 0


# ---- the blocks and a train step --------------------------------------------


def _block_weights(cfg_r, mixer, seed):
    """The first `mixer` layer's weights of a reduced config, from the
    reference's initialiser (norm scales perturbed), as numpy float32."""
    p = r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(seed))
    j = [m for m, _ in cfg_r.pattern].index(mixer)
    rng = np.random.default_rng(seed)
    out = {}
    for name, x in p.items():
        if name.startswith(f"blk{j}.mix."):
            x = np.array(x, np.float32)[0]
            if name.rsplit(".", 1)[-1] in ("ln", "mn"):
                x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
            out[name.replace(f"blk{j}.", "blk.")] = x  # the block's prefix: "blk.mix"
    return out


@pytest.mark.parametrize("arch,mixer", [("xlstm-350m", "mlstm"), ("recurrentgemma-9b", "rglru")])
def test_block_gradients_match_the_reference(arch, mixer):
    """mlstm_block / rglru_block in float32 (S = 40): the gradient of a
    random projection of the output with respect to the input and every
    weight, through the port's Functions against `jax.vjp` of the
    reference's block."""
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    w = _block_weights(cfg_r, mixer, seed=23)
    rng = np.random.default_rng(29)
    x = rng.standard_normal((2, 40, cfg_r.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 40, cfg_r.d_model)).astype(np.float32)
    r_block = {"mlstm": r_xlstm.mlstm_block, "rglru": r_rglru.rglru_block}[mixer]
    t_block = {"mlstm": t_xlstm.mlstm_block, "rglru": t_rglru.rglru_block}[mixer]
    names = sorted(w)
    ref = _jax_vjp(lambda xx, *ws: r_block(cfg_r, dict(zip(names, ws)), "blk.mix", xx)[0],
                   [jnp.asarray(x)] + [jnp.asarray(w[n]) for n in names], jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(True)]
    leaves += [torch.from_numpy(w[n]).requires_grad_(True) for n in names]
    out = t_block(cfg_t, dict(zip(names, leaves[1:])), "blk.mix", leaves[0])[0]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, r in zip(["x"] + names, got, ref):
        _hold(a, np.asarray(r), "float32", f"{arch} {mixer} block d{name}")


def _reduced_step_inputs(arch, seed):
    """A reduced config's reference weights (PRNGKey(seed)) and a batch of
    2 x 32 random tokens, as numpy."""
    cfg_r = r_registry.reduced(arch)
    p = r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(seed))
    toks = np.random.default_rng(seed + 31).integers(0, cfg_r.vocab, (2, 33)).astype(np.int32)
    return cfg_r, {k: np.asarray(v) for k, v in p.items()}, {"tokens": toks[:, :-1],
                                                             "labels": toks[:, 1:]}


def _port_grads(cfg, weights, batch):
    p = interop.params_from_numpy(weights, torch.device("cpu"))
    return t_model.accumulated_grads(cfg, p, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,act", [("xlstm-350m", "float32"), ("recurrentgemma-9b", "bfloat16")])
def test_train_step_through_the_functions(arch, act, monkeypatch):
    """One reduced step: the loss (bf16 activations) within 2e-3 of the
    reference's `loss_fn`; every gradient leaf through the mLSTM / RG-LRU
    Functions (their explicit backwards) within 1e-4 relative L2 of
    autograd through the plain forwards, the route the stack took before
    the kernels had a backward, with the activations in `act`. xLSTM is
    held in float32: in bf16 its gate gradients (dlogi, dlogf: sums of dD~
    that cancel) turn the two routes' float32 rounding into 2-5% relative
    L2 on blk*.mix.bi / bf / wi. The port's bf16 gradients also differ from
    the reference's by up to ~6% on this step on leaves whose path this
    slice does not touch (reduced recurrentgemma-9b's blk0.ffn.ln2: 0.042
    by either route), so the reference holds the gradients at the blocks in
    float32 (`test_block_gradients_match_the_reference`)."""
    cfg_r, weights, batch = _reduced_step_inputs(arch, 0)
    cfg_t = t_registry.reduced(arch)
    loss_r = jax.jit(lambda w, b: r_model.loss_fn(cfg_r, w, b))(
        {k: jnp.asarray(v) for k, v in weights.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(_port_grads(cfg_t, weights, batch)[0]) - float(loss_r)) <= 2e-3
    monkeypatch.setattr(t_stack, "ACT_DTYPE", getattr(torch, act))
    loss, grads = _port_grads(cfg_t, weights, batch)
    monkeypatch.setattr(m_ops, "mlstm", mlstm_ref)
    monkeypatch.setattr(r_ops, "rglru", lambda la, gx, h0=None: rglru_ref(
        la.float(), gated_input(la.float(), gx), h0))
    loss_plain, plain = _port_grads(cfg_t, weights, batch)
    assert torch.equal(loss, loss_plain)
    for n in plain:
        assert _rel_l2(grads[n].numpy(), plain[n].numpy()) <= 1e-4, n


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_xlstm_remat_is_bitwise_the_plain_backward(remat):
    """One pattern group of reduced xlstm-350m (7 mLSTM layers through
    `_Mlstm` and the sLSTM): the recomputing backward gives the same loss
    and gradients bit for bit."""
    cfg = t_registry.reduced("xlstm-350m")
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    p = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in r_init_params(
            r_stack.build_schema(dataclasses.replace(r_registry.reduced("xlstm-350m"),
                                                     n_layers=len(cfg.pattern))),
            jax.random.PRNGKey(1)).items()}, torch.device("cpu"))
    toks = torch.from_numpy(np.random.default_rng(37).integers(0, cfg.vocab, (2, 25)))
    b = {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}
    loss0, g0 = t_model.accumulated_grads(cfg, p, b, remat=False)
    loss1, g1 = t_model.accumulated_grads(cfg, p, b, remat=remat)
    assert torch.equal(loss0, loss1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
