"""The recurrent slice of the port against the reference: the mLSTM (B5) and
RG-LRU (B4) kernels' plain versions and wrappers, the logit softcap of both
attention kernels, and the xLSTM / RG-LRU model functions and blocks.

Tolerances, each with its reason:
- kernels' plain versions: the reference kernel tests' own limits
  (`tests/kernels/test_kernels.py`), 10 x TOL for mLSTM and 5 x TOL for
  RG-LRU (TOL = 2e-5 float32, 2e-2 bfloat16, abs = rel): both compute in
  float32 and differ from the oracles by summation order, and in bfloat16
  by the output's rounding;
- softcapped attention: TOL (float32 math in another order; in bfloat16
  the output's rounding), the reference fed the same values in float32;
- model functions in float32: 1e-5 abs + rel (float32 math in another
  order; the decode update and the final state are a handful of ops);
- blocks: 1e-4 in float32 (a block chains ~20 float32 ops and two
  products, each off by an ulp or so), and 0.08 in bfloat16, the
  reference's limit for recurrent stacks (`tests/models/test_archs.py`),
  against the reference's blocks compiled with `jax.jit`, as its stack
  runs them.
"""

import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as r_registry
from repro.kernels.mlstm.mlstm import mlstm_chunk as r_mlstm_chunk
from repro.kernels.mlstm.ref import mlstm_ref as r_mlstm_ref
from repro.kernels.rglru.ref import rglru_ref as r_rglru_ref
from repro.models import attention as r_attn
from repro.models import rglru as r_rglru
from repro.models import stack as r_stack
from repro.models import xlstm as r_xlstm
from repro.models.schema import init_params as r_init_params
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as t_dec
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.mlstm import mlstm as t_mlstm_bind
from repro_torch.kernels.mlstm import ops as t_mlstm
from repro_torch.kernels.mlstm.ref import mlstm_ref
from repro_torch.kernels.rglru import ops as t_rglru
from repro_torch.kernels.rglru import rglru as t_rglru_bind
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import rglru as t_rglru_model
from repro_torch.models import stack as t_stack
from repro_torch.models import xlstm as t_xlstm

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/kernels/test_kernels.py
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference kernel tests' cases (tests/kernels/test_kernels.py)
MLSTM_CASES = [(1, 2, 256, 64), (2, 4, 128, 128), (1, 1, 512, 32)]  # (B, H, S, dh)
RGLRU_CASES = [(2, 256, 128), (1, 512, 512), (3, 128, 96)]  # (B, S, E)
F32_TOL = 1e-5
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 0.08}


def _both(x, dtype):
    """One numpy array as a reference array and a port tensor of `dtype`."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(out, ref, tol, label=""):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=label)


def test_cases_are_the_reference_kernel_tests():
    spec = importlib.util.spec_from_file_location(
        "_ref_kernel_tests", ROOT / "tests" / "kernels" / "test_kernels.py"
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert MLSTM_CASES == ref.MLSTM_CASES == chip_smoke.MLSTM_CASES
    assert RGLRU_CASES == ref.RGLRU_CASES == chip_smoke.RGLRU_CASES


# ---- B5: mLSTM ---------------------------------------------------------------


def _mlstm_inputs(B, H, S, dh, seed):
    """The reference kernel test's distribution: q, k, v ~ N(0, 1), logi ~
    N(0, 0.25), logf = log sigmoid(N(2, 1))."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, dh), np.float32) for _ in range(3))
    logi = (0.5 * rng.standard_normal((B, H, S))).astype(np.float32)
    logf = -np.logaddexp(0, -(rng.standard_normal((B, H, S)) + 2.0)).astype(np.float32)
    return q, k, v, logi, logf


@pytest.mark.parametrize("case", MLSTM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_plain_version_matches_reference(case, dtype):
    q, k, v, logi, logf = _mlstm_inputs(*case, seed=3)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    tli, tlf = torch.from_numpy(logi), torch.from_numpy(logf)
    launches = t_mlstm.mlstm.launches
    out = t_mlstm.mlstm(tq, tk, tv, tli, tlf)
    assert t_mlstm.mlstm.launches == launches  # CPU tensors: the plain version, no launch
    assert out.shape == tq.shape and out.dtype == tv.dtype
    assert torch.equal(out, mlstm_ref(tq, tk, tv, tli, tlf))
    tol = 10 * TOL[dtype]
    pallas = r_mlstm_chunk(jq, jk, jv, jnp.asarray(logi), jnp.asarray(logf), bq=64, bk=64,
                           interpret=True)
    _close(out, pallas, tol, "vs mlstm_chunk (interpret)")
    _close(out, r_mlstm_ref(jq, jk, jv, jnp.asarray(logi), jnp.asarray(logf)), tol, "vs ref")


@pytest.mark.parametrize("S,dh", [(100, 48), (700, 32)])
def test_mlstm_takes_a_ragged_sequence(S, dh):
    """S that no power-of-two block divides (700 is also where the
    reference's `mlstm_parallel` drops rows, ROADMAP C4)."""
    q, k, v, logi, logf = _mlstm_inputs(1, 2, S, dh, seed=4)
    out = t_mlstm.mlstm(*(torch.from_numpy(x) for x in (q, k, v, logi, logf)))
    ref = r_mlstm_ref(*(jnp.asarray(x) for x in (q, k, v, logi, logf)))
    assert out.shape == (1, 2, S, dh)
    _close(out, ref, 10 * TOL["float32"])
    # the model's contract function runs every row; the reference's keeps 512
    t_par = t_xlstm.mlstm_parallel(*(torch.from_numpy(x) for x in (q, k, v, logi, logf)))
    assert torch.equal(t_par, out)
    r_par = r_xlstm.mlstm_parallel(*(jnp.asarray(x) for x in (q, k, v, logi, logf)))
    assert r_par.shape[2] == min(S, 512)


# ---- B4: RG-LRU --------------------------------------------------------------


def _rglru_inputs(B, S, E, seed):
    """The reference kernel test's distribution: log_a = -0.05 exp(N(0, 1))
    (long memory), gated x ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    log_a = (-np.exp(rng.standard_normal((B, S, E))) * 0.05).astype(np.float32)
    gx = rng.standard_normal((B, S, E)).astype(np.float32)
    return log_a, gx


@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_version_matches_reference(case, dtype):
    """Held against `rglru_ref`, not the Pallas kernel, which does not run
    under the installed jax (ROADMAP C1)."""
    log_a, gx = _rglru_inputs(*case, seed=2)
    jgx, tgx = _both(gx, dtype)
    tla = torch.from_numpy(log_a)
    a = jnp.exp(jnp.asarray(log_a))
    b = (jnp.sqrt(jnp.clip(1 - a * a, 0, 1)) * jgx.astype(jnp.float32)).astype(DTYPES[dtype][0])
    ref = r_rglru_ref(jnp.asarray(log_a), b)
    tol = 5 * TOL[dtype]
    launches = t_rglru.rglru_scan.launches
    out = t_rglru.rglru(tla, tgx)  # the reference op: gate transform, cast of b, scan
    assert t_rglru.rglru_scan.launches == launches
    assert out.shape == tgx.shape and out.dtype == tgx.dtype
    _close(out, ref, tol, "rglru vs rglru_ref")
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).to(DTYPES[dtype][1])
    scan = t_rglru.rglru_scan(tla, tb)
    assert torch.equal(scan, rglru_ref(tla, tb))
    _close(scan, ref, tol, "rglru_scan vs rglru_ref")


def test_rglru_scan_matches_the_reference_model_function():
    """`models/rglru.py:43` (an associative scan) in float32."""
    log_a, gx = _rglru_inputs(2, 300, 64, seed=5)
    out = t_rglru_model.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(gx))
    ref = r_rglru.rglru_scan(jnp.asarray(log_a), jnp.asarray(gx))
    _close(out, ref, F32_TOL)


# ---- softcap in B3 / B2 ------------------------------------------------------


def _capped_inputs(shapes, dtype, seed):
    """Inputs of 3 x N(0, 1), so the scores (~N(0, 81) at dh 32) reach past
    both caps (cap 5 saturates tanh). A bf16 case hands the reference the
    same bf16 values in float32: the reference's bf16 einsum would round the
    scores to bf16 (an ulp of 0.125 at |s| ~ 20) before the cap, which the
    plain version, like the kernels, does not; so what is compared is the
    cap and the softmax, within the output's bf16 rounding."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        t = torch.from_numpy(3 * rng.standard_normal(s, np.float32)).to(DTYPES[dtype][1])
        out.append((jnp.asarray(t.float().numpy()), t))
    return out


@pytest.mark.parametrize("cap", [50.0, 5.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 24])
def test_softcapped_flash_plain_version_matches_reference(cap, dtype, window):
    B, S, H, KV, dh = 2, 96, 4, 1, 32
    (jq, q), (jk, k), (jv, v) = _capped_inputs(
        ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)), dtype, 7)
    out = t_flash.mha(q, k, v, window=window, logit_cap=cap)
    ref = r_attn.chunked_attention(jq, jk, jv, window=window, q_chunk=32, logit_cap=cap)
    tol = TOL[dtype]
    _close(out, ref, tol)
    # the cap changed the result: the uncapped scores reach past it
    assert not torch.allclose(out.float(), t_flash.mha(q, k, v, window=window).float(),
                              atol=tol, rtol=tol)
    # the model's contract function passes the cap on
    assert torch.equal(t_attn.chunked_attention(q, k, v, window=window, logit_cap=cap), out)


@pytest.mark.parametrize("cap", [50.0, 5.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcapped_decode_plain_version_matches_reference(cap, dtype):
    B, Sc, H, KV, dh = 3, 80, 8, 1, 32
    (jq, q), (jk, k), (jv, v) = _capped_inputs(
        ((B, 1, H, dh), (B, Sc, KV, dh), (B, Sc, KV, dh)), dtype, 8)
    valid = np.arange(Sc)[None, :] <= np.array([0, 40, 79])[:, None]
    out = t_attn.decode_attention(q, k, v, torch.from_numpy(valid), logit_cap=cap)
    ref = r_attn.decode_attention(jq, jk, jv, jnp.asarray(valid), logit_cap=cap)
    _close(out, ref, TOL[dtype])
    assert torch.equal(out, t_dec.decode(q, k, v, torch.from_numpy(valid), logit_cap=cap))


# ---- model functions and blocks ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_is_the_references(dtype):
    """Tap by tap in the input's dtype, rounding where the reference does."""
    rng = np.random.default_rng(9)
    (jx, x), (jw, w) = (_both(rng.standard_normal(s, np.float32), dtype)
                        for s in ((2, 19, 48), (4, 48)))
    out = t_xlstm.causal_conv(x, w)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(r_xlstm.causal_conv(jx, jw), np.float32))


def test_mlstm_step_and_final_state_match_reference():
    B, H, S, dh = 2, 3, 17, 16
    q, k, v, logi, logf = _mlstm_inputs(B, H, S, dh, seed=10)
    st_r = r_xlstm.mlstm_final_state(*(jnp.asarray(x) for x in (k, v, logi, logf)))
    st_t = t_xlstm.mlstm_final_state(*(torch.from_numpy(x) for x in (k, v, logi, logf)))
    for name in ("C", "n", "m"):
        _close(st_t[name], st_r[name], F32_TOL, name)
    # one decode step from that state, then compare with the parallel form
    # over the sequence extended by that step
    rng = np.random.default_rng(11)
    qs, ks, vs = (rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(3))
    li, lf = logi[..., 0], logf[..., 0]
    new_r, h_r = r_xlstm.mlstm_step(st_r, *(jnp.asarray(x) for x in (qs, ks, vs, li, lf)))
    new_t, h_t = t_xlstm.mlstm_step(st_t, *(torch.from_numpy(x) for x in (qs, ks, vs, li, lf)))
    _close(h_t, h_r, F32_TOL, "h")
    for name in ("C", "n", "m"):
        _close(new_t[name], new_r[name], F32_TOL, f"step {name}")
    full = t_xlstm.mlstm_parallel(*(torch.from_numpy(np.concatenate([a, b[..., None, :]], 2))
                                    for a, b in ((q, qs), (k, ks), (v, vs))),
                                  torch.from_numpy(np.concatenate([logi, li[..., None]], 2)),
                                  torch.from_numpy(np.concatenate([logf, lf[..., None]], 2)))
    _close(h_t, full[:, :, -1], 1e-4, "decode step == parallel form's last row")


def _block_weights(arch, pfx):
    """One layer's reference weights (the stacked [0] slice), with the
    zero-initialized norm scales perturbed so they reach the output."""
    cfg = r_registry.reduced(arch)
    p = r_init_params(r_stack.build_schema(cfg), jax.random.PRNGKey(1))
    rng = np.random.default_rng(12)
    out = {}
    for name, x in p.items():
        if not name.startswith(pfx + "."):
            continue
        x = np.asarray(x)[0] if name.startswith("blk") else np.asarray(x)
        if name.rsplit(".", 1)[-1] in ("ln", "mn"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        out[name] = x
    return out


BLOCKS = {
    # name: (arch, layer prefix, reference block, port block)
    "mlstm": ("xlstm-350m", "blk0", r_xlstm.mlstm_block, t_xlstm.mlstm_block),
    "slstm": ("xlstm-350m", "blk3", r_xlstm.slstm_block, t_xlstm.slstm_block),
    "rglru": ("recurrentgemma-9b", "blk0", r_rglru.rglru_block, t_rglru_model.rglru_block),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_prefill_then_decode_matches_reference(block, dtype):
    """Prefill with return_state, then two decode steps from the port's own
    state; outputs and every state leaf against the reference's."""
    arch, pfx, r_block, t_block = BLOCKS[block]
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    w = _block_weights(arch, pfx)
    p_r = {k: jnp.asarray(v) for k, v in w.items()}
    p_t = interop.params_from_numpy(w)
    if dtype == "bfloat16":  # the serving path's bf16 copies, made once
        p_t = t_stack.cast_weights(cfg_t, p_t)
    jdt, tdt = DTYPES[dtype]
    tol = BLOCK_TOL[dtype]
    x = np.random.default_rng(13).standard_normal((2, 23, cfg_r.d_model)).astype(np.float32)
    run_r = jax.jit(functools.partial(r_block, cfg_r, prefix=pfx + ".mix"),
                    static_argnames=("return_state",))
    y_r, st_r = run_r(p_r, x=jnp.asarray(x[:, :21], jdt), return_state=True)
    y_t, st_t = t_block(cfg_t, p_t, pfx + ".mix", torch.from_numpy(x[:, :21]).to(tdt),
                        return_state=True)
    assert y_t.dtype == tdt
    _close(y_t, y_r, tol, f"{block} prefill out")
    ref_leaves = dict(_leaves(st_r))
    got_leaves = dict(_leaves(st_t))
    assert set(got_leaves) == set(ref_leaves)
    for name, ref in ref_leaves.items():
        got = got_leaves[name]
        assert tuple(got.shape) == ref.shape, name
        assert got.dtype == (tdt if name == ".conv" else torch.float32), name  # float32 states
        _close(got, ref, tol, f"{block} state {name}")
    for t in (21, 22):
        xt = x[:, t : t + 1]
        y_r, st_r = run_r(p_r, x=jnp.asarray(xt, jdt), cache=st_r)
        y_t, st_t = t_block(cfg_t, p_t, pfx + ".mix", torch.from_numpy(xt).to(tdt), cache=st_t)
        _close(y_t, y_r, tol, f"{block} decode out at {t}")
        for (name, got), (_, ref) in zip(_leaves(st_t), _leaves(st_r)):
            _close(got, ref, tol, f"{block} decode state {name} at {t}")


# ---- the wrappers on the card's side of the line ------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((1, 2, 8, 16))
    g = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="logi/logf"):
        t_mlstm.mlstm(q, q, q, g[..., :4], g)
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        t_mlstm.mlstm(q, q.half(), q.half(), g, g)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 1, 4, 264))
        t_mlstm.mlstm(big, big, big, g[:1, :1, :4], g[:1, :1, :4])
    la = torch.zeros((1, 8, 4))
    with pytest.raises(TypeError, match="log_a must be float32"):
        t_rglru.rglru_scan(la.bfloat16(), la)
    with pytest.raises(ValueError, match="share"):
        t_rglru.rglru_scan(la, la[:, :4])
    with pytest.raises(ValueError, match="logit_cap"):
        t_flash.mha(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), logit_cap=-1.0)


@pytest.mark.parametrize("kernel", ["mlstm", "rglru"])
def test_cuda_tensor_whose_binding_fails_raises(kernel, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: a binding
    that cannot load never turns into the plain version's result."""

    def broken(name):
        raise OSError(f"cannot load lib{name}.so")

    monkeypatch.setattr(_build, "load", broken)
    t_mlstm_bind.entry.cache_clear()
    t_rglru_bind.entry.cache_clear()
    counters = (t_mlstm.mlstm.launches, t_rglru.rglru_scan.launches)
    with FakeTensorMode():  # tensors that say cuda, without a card
        with pytest.raises(OSError, match="cannot load"):
            if kernel == "mlstm":
                q = torch.empty((1, 2, 16, 32), device="cuda")
                g = torch.empty((1, 2, 16), device="cuda")
                t_mlstm.mlstm(q, q, q, g, g)
            else:
                x = torch.empty((1, 16, 32), device="cuda")
                t_rglru.rglru_scan(x, x)
    assert (t_mlstm.mlstm.launches, t_rglru.rglru_scan.launches) == counters
    t_mlstm_bind.entry.cache_clear()
    t_rglru_bind.entry.cache_clear()


@pytest.mark.cuda
def test_recurrent_kernels_and_softcap_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(MLSTM_CASES):
            chip_smoke.check_mlstm(case, dtype, dev, seed=i)
        for i, case in enumerate(RGLRU_CASES):
            chip_smoke.check_rglru(case, dtype, dev, seed=i)
        for cap in chip_smoke.SOFTCAPS:
            for i, case in enumerate(chip_smoke.FLASH_CASES):
                chip_smoke.check_flash(case, dtype, dev, seed=i, logit_cap=cap)
            for i, case in enumerate(chip_smoke.DECODE_CASES):
                chip_smoke.check_decode(case, dtype, dev, seed=i, logit_cap=cap)
