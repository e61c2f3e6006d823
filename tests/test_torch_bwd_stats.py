"""The row statistics that the flash and mLSTM forwards save for their
backwards, on the CPU: the plain versions' (`attention_ref(...,
with_lse=True)`, `mlstm_ref(..., with_stats=True)`, which the card's
kernels are held against) against the same quantities formed with `jnp`
from the reference's definitions, and the autograd Functions passing them
from the forward to the backward.

- flash: lse = logsumexp_j of the masked, capped scores of
  `src/repro/kernels/flash_attention/ref.py::attention_ref` (the cap is
  `repro.models.layers.softcap`'s tanh(s / c) c, applied before the mask as
  the model's attention applies it), causal, windowed, chunk-local,
  non-causal, dv < dh and cross-attention (Sk != Sq); float32 math on both
  sides, 1e-5 abs + rel (sums in another order).
- mLSTM: m and n of `src/repro/models/xlstm.py::mlstm_parallel` (m_i = max_j
  D~, σ_i = Σ_j s q_i·k_j exp(D~_ij - m_i)), n the normaliser
  max(|σ_i|, exp(-m_i), 1e-30) signed as σ_i where |σ_i| sets it; m within
  1e-5 abs + rel, n within 1e-5 abs and 1e-4 rel (σ is a signed sum in
  another order); float32 and bf16 heads (both sides read the same bf16
  values in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.mlstm import ops as m_ops
from repro_torch.kernels.mlstm.ref import mlstm_bwd_ref, mlstm_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, Sq, Sk, H, KV, dh, dv, causal, window, chunk_local, cap)
LSE_CASES = {
    "causal": (2, 70, 70, 4, 2, 32, 32, True, 0, False, 0.0),
    "cap": (1, 64, 64, 4, 1, 32, 32, True, 0, False, 5.0),
    "window_cap": (1, 90, 90, 2, 1, 48, 48, True, 24, False, 50.0),
    "chunk_local": (2, 64, 64, 6, 2, 32, 32, True, 16, True, 0.0),
    "narrow_v": (1, 48, 48, 4, 4, 48, 32, True, 0, False, 0.0),
    "non_causal": (1, 50, 50, 2, 1, 40, 40, False, 0, False, 0.0),
    "cross": (2, 24, 70, 4, 2, 32, 32, False, 0, False, 0.0),
}
STAT_TOL = 1e-5
# (B, H, S, dh): S below and above one 64-row tile, a ragged S
MLSTM_CASES = [(2, 2, 64, 32), (1, 3, 100, 16), (1, 1, 7, 8)]


def _flash_inputs(case, seed=0):
    """q [B,H,Sq,dh], k [B,KV,Sk,dh], v [B,KV,Sk,dv], the kernel's layout,
    numpy float32; inputs scaled by 3 so that the cap bites."""
    B, Sq, Sk, H, KV, dh, dv, *_ = case
    rng = np.random.default_rng(seed)
    return [3.0 * rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, dh), (B, KV, Sk, dh), (B, KV, Sk, dv))]


def _reference_lse(case, q, k):
    """logsumexp of the scores as the reference's `attention_ref` masks
    them, capped first by `layers.softcap` (jnp, float32)."""
    B, Sq, Sk, H, KV, dh, dv, causal, window, cl, cap = case
    kf = jnp.repeat(jnp.asarray(k), H // KV, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kf) * (dh**-0.5)
    if cap:
        s = r_layers.softcap(s, cap)
    qpos, kpos = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (kpos // window) == (qpos // window) if cl else kpos > qpos - window
    return np.asarray(jax.scipy.special.logsumexp(jnp.where(mask, s, -1e30), axis=-1))


@pytest.mark.parametrize("name", list(LSE_CASES))
def test_plain_lse_is_the_logsumexp_of_the_reference_scores(name):
    case = LSE_CASES[name]
    *_, causal, window, cl, cap = case
    q, k, v = _flash_inputs(case)
    kw = dict(causal=causal, window=window, chunk_local=cl, logit_cap=cap)
    out, lse = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == out.shape[:3]
    np.testing.assert_allclose(lse.numpy(), _reference_lse(case, q, k), atol=STAT_TOL,
                               rtol=STAT_TOL, err_msg=name)


def _mlstm_inputs(case, seed):
    """The reference kernel test's distribution (numpy float32): q, k, v ~
    N(0, 1), logi ~ N(0, 0.25), logf = log sigmoid(N(2, 1))."""
    B, H, S, dh = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, dh)).astype(np.float32) for _ in range(3))
    logi = (0.5 * rng.standard_normal((B, H, S))).astype(np.float32)
    logf = -np.logaddexp(0.0, -(rng.standard_normal((B, H, S)) + 2.0)).astype(np.float32)
    return q, k, v, logi, logf


def _reference_stats(q, k, logi, logf):
    """m and the signed n of `repro.models.xlstm.mlstm_parallel`'s
    definition, formed with jnp (one query chunk: every row at once)."""
    S, dh = q.shape[-2:]
    F = jnp.cumsum(jnp.asarray(logf), axis=-1)
    Dt = F[..., :, None] - F[..., None, :] + jnp.asarray(logi)[..., None, :]
    causal = jnp.arange(S)[None, :] <= jnp.arange(S)[:, None]
    Dt = jnp.where(causal, Dt, -jnp.inf)
    m = jnp.maximum(jnp.max(Dt, axis=-1), -1e30)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k)) * dh**-0.5
    sigma = jnp.sum(s * jnp.exp(Dt - m[..., None]), axis=-1)
    floor = jnp.maximum(jnp.exp(-m), 1e-30)
    return np.asarray(m), np.asarray(jnp.where(jnp.abs(sigma) > floor, sigma, floor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLSTM_CASES)
def test_plain_mlstm_stats_match_the_reference_definition(case, dtype):
    q, k, v, logi, logf = _mlstm_inputs(case, seed=3)
    qt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    h, m, n = mlstm_ref(qt, kt, vt, torch.from_numpy(logi), torch.from_numpy(logf),
                        with_stats=True)
    assert torch.equal(h, mlstm_ref(qt, kt, vt, torch.from_numpy(logi), torch.from_numpy(logf)))
    m_r, n_r = _reference_stats(qt.float().numpy(), kt.float().numpy(), logi, logf)
    np.testing.assert_allclose(m.numpy(), m_r, atol=STAT_TOL, rtol=STAT_TOL)
    np.testing.assert_allclose(n.numpy(), n_r, atol=STAT_TOL, rtol=10 * STAT_TOL)
    assert m.dtype == n.dtype == torch.float32 and m.shape == n.shape == qt.shape[:3]


def test_mha_saves_the_forwards_lse_and_passes_it_to_the_backward(monkeypatch):
    """`_Mha` saves the forward's lse and hands it to `mha_backward`
    (monkeypatched to record its arguments): equal bit for bit to the plain
    forward's, and the gradients are `attention_bwd_ref`'s on it."""
    case = LSE_CASES["window_cap"]
    *_, causal, window, cl, cap = case
    kw = dict(causal=causal, window=window, chunk_local=cl, logit_cap=cap)
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(case, seed=1))
    seen = {}
    real = f_ops.mha_backward

    def record(*args, **kwargs):
        seen["args"] = args
        return real(*args, **kwargs)

    monkeypatch.setattr(f_ops, "mha_backward", record)
    leaves = [x.transpose(1, 2).clone().requires_grad_(True) for x in (q, k, v)]
    out = f_ops.mha(*leaves, **kw)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    out.backward(g)
    o_ref, lse_ref = attention_ref(q, k, v, **kw, with_lse=True)
    lse = seen["args"][5]
    assert torch.equal(lse, lse_ref) and torch.equal(seen["args"][3], o_ref)
    want = attention_bwd_ref(q, k, v, o_ref, g.transpose(1, 2), lse_ref, **kw)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w.transpose(1, 2))


def test_mlstm_saves_the_forwards_m_and_n_and_passes_them_to_the_backward(monkeypatch):
    """`_Mlstm` saves the forward's m and n and hands them to `mlstm_bwd`
    (monkeypatched to record its arguments): equal bit for bit to the
    plain forward's, and the gradients are `mlstm_bwd_ref`'s on them."""
    q, k, v, logi, logf = (torch.from_numpy(x) for x in _mlstm_inputs((1, 2, 70, 16), seed=5))
    seen = {}
    real = m_ops.mlstm_bwd

    def record(*args):
        seen["args"] = args
        return real(*args)

    monkeypatch.setattr(m_ops, "mlstm_bwd", record)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, logi, logf)]
    out = m_ops.mlstm(*leaves)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
    grads = torch.autograd.grad(out, leaves, g)
    h, m, n = mlstm_ref(q, k, v, logi, logf, with_stats=True)
    assert torch.equal(seen["args"][7], m) and torch.equal(seen["args"][8], n)
    F = torch.cumsum(logf, dim=-1)
    want = mlstm_bwd_ref(q, k, v, logi, F, h, g, m, n)
    for a, w in zip(grads[:4], want[:4]):
        assert torch.equal(a, w)


def test_the_backwards_check_the_statistics_they_are_given():
    """A statistic of the wrong shape or dtype raises before any work."""
    case = LSE_CASES["causal"]
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(case))
    out, lse = attention_ref(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="lse must be float32"):
        f_ops.mha_backward(q, k, v, out, out, lse[..., :-1])
    with pytest.raises(ValueError, match="lse must be float32"):
        f_ops.mha_backward(q, k, v, out, out, lse.double())
    x = [torch.from_numpy(a) for a in _mlstm_inputs((1, 1, 16, 8), seed=7)]
    h, m, n = mlstm_ref(*x, with_stats=True)
    F = torch.cumsum(x[4], dim=-1)
    with pytest.raises(ValueError, match="n must be float32"):
        m_ops.mlstm_bwd(x[0], x[1], x[2], x[3], F, h, h, m, n[..., :-1])
