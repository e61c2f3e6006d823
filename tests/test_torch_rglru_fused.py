"""The RG-LRU op of the port with its carry h0 (B4's fused entry) against
the reference, on the CPU.

`ops.rglru(log_a, gated_x, h0)` is the reference op
`repro.kernels.rglru.ops.rglru` (b = sqrt(clip(1 - a², 0, 1)) · gated_x in
float32, cast to gated_x's dtype) followed by the scan from h0. The Pallas
kernel does not run under the installed jax (ROADMAP C1), so the reference
here is `repro.kernels.rglru.ref.rglru_ref(log_a, b, h0)` with b formed as
the reference op forms it.

Tolerances, each with its reason:
- the op against the reference: TOL (2e-5 float32, 2e-2 bfloat16, abs =
  rel, the reference kernel tests' `TOL`): both compute in float32, the
  exp of another library may differ by an ulp, and in bfloat16 b and the
  output are rounded;
- a block's decode step against a prefill one step longer: 1e-5 abs + rel
  in float32 (the decode conv and the products take another summation
  order than the prefill's) and 0.08 in bfloat16, the reference's limit
  for recurrent stacks (`tests/models/test_archs.py`);
- the exact carry checks and two calls: equal bit for bit.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.rglru.ref import rglru_ref as r_rglru_ref
from repro_torch.configs import registry as t_registry
from repro_torch.kernels import _build
from repro_torch.kernels.rglru import ops
from repro_torch.kernels.rglru import rglru as binding
from repro_torch.kernels.rglru.ref import gated_input, rglru_ref
from repro_torch.models import rglru as t_rglru_model
from repro_torch.models import stack as t_stack
from repro_torch.models.schema import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 0.08}
# the reference kernel tests' cases, decode's one step, and a ragged S and E
CASES = chip_smoke.RGLRU_CASES + [(4, 1, 64), (2, 67, 13)]


def _inputs(B, S, E, seed):
    """log_a = -0.05 exp(N(0, 1)) (the reference kernel test's), gated x
    ~ N(0, 1) and a carry h0 ~ N(0, 1) [B,E]."""
    rng = np.random.default_rng(seed)
    log_a = (-np.exp(rng.standard_normal((B, S, E))) * 0.05).astype(np.float32)
    gx = rng.standard_normal((B, S, E)).astype(np.float32)
    return log_a, gx, rng.standard_normal((B, E)).astype(np.float32)


def _reference(log_a, gx, h0, dtype):
    """The reference op's b (src/repro/kernels/rglru/ops.py), then
    `rglru_ref` from h0."""
    jdt = DTYPES[dtype][0]
    a = jnp.exp(jnp.asarray(log_a))
    gxj = jnp.asarray(gx, jdt)
    b = (jnp.sqrt(jnp.clip(1.0 - a * a, 0.0, 1.0)) * gxj.astype(jnp.float32)).astype(jdt)
    return r_rglru_ref(jnp.asarray(log_a), b, None if h0 is None else jnp.asarray(h0))


def _close(out, ref, tol, label=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=label)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_op_matches_reference(case, dtype, with_h0):
    log_a, gx, h0 = _inputs(*case, seed=sum(case))
    h0 = h0 if with_h0 else None
    tdt = DTYPES[dtype][1]
    launches = (ops.rglru.launches, ops.rglru_scan.launches)
    out = ops.rglru(torch.from_numpy(log_a), torch.from_numpy(gx).to(tdt),
                    h0=None if h0 is None else torch.from_numpy(h0))
    assert (ops.rglru.launches, ops.rglru_scan.launches) == launches  # plain calls
    assert out.shape == case and out.dtype == tdt
    _close(out, _reference(log_a, gx, h0, dtype), TOL[dtype], f"rglru {case} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_is_the_plain_composition(dtype):
    """On the CPU the op is `gated_input` then `rglru_ref`, bit for bit."""
    tdt = DTYPES[dtype][1]
    la, gx, h0 = (torch.from_numpy(x) for x in _inputs(2, 40, 24, seed=3))
    gx = gx.to(tdt)
    b = gated_input(la, gx)
    assert b.dtype == tdt
    assert torch.equal(ops.rglru(la, gx), rglru_ref(la, b))
    assert torch.equal(ops.rglru(la, gx, h0=h0), rglru_ref(la, b, h0))
    assert torch.equal(ops.rglru(la, gx), ops.rglru_scan(la, b))


def _block_params(cfg, dtype):
    """recurrentgemma's first RG-LRU layer (reduced), weights from seed 0;
    in bf16 the serving path's casts."""
    schema = {k: v for k, v in t_stack.build_schema(cfg).items() if k.startswith("blk0.mix.")}
    p = {k: v[0] for k, v in init_params(schema, torch.Generator().manual_seed(0), "cpu").items()}
    return t_stack.cast_weights(cfg, p) if dtype == "bfloat16" else p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 20, 64])
def test_block_decode_step_matches_a_longer_prefill(dtype, S):
    """`rglru_block`: prefill S with its state, then one decode step (the op
    at S = 1 from h0) against the last position of a prefill of S + 1."""
    cfg = t_registry.reduced("recurrentgemma-9b")
    tdt = DTYPES[dtype][1]
    p = _block_params(cfg, dtype)
    x = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (2, S + 1, cfg.d_model)).astype(np.float32)).to(tdt)
    block = t_rglru_model.rglru_block
    _, state = block(cfg, p, "blk0.mix", x[:, :S], return_state=True)
    y_step, st_step = block(cfg, p, "blk0.mix", x[:, S:], cache=state)
    y_full, st_full = block(cfg, p, "blk0.mix", x, return_state=True)
    tol = BLOCK_TOL[dtype]
    assert y_step.shape == (2, 1, cfg.d_model) and y_step.dtype == tdt
    _close(y_step, y_full[:, -1:].float().numpy(), tol, "decode step output")
    assert st_step["h"].dtype == torch.float32 and st_step["h"].shape == st_full["h"].shape
    _close(st_step["h"], st_full["h"].numpy(), tol, "decode step carry")
    assert torch.equal(st_step["conv"], st_full["conv"])


def test_block_decode_goes_through_the_op_with_h0(monkeypatch):
    """Prefill hands the op [B,S,E] without a carry, decode [B,1,E] with the
    cached h: one launch a layer on the card for each."""
    cfg = t_registry.reduced("recurrentgemma-9b")
    p = _block_params(cfg, "float32")
    seen = []
    real = ops.rglru

    def record(log_a, gated_x, h0=None):
        seen.append((tuple(gated_x.shape), None if h0 is None else tuple(h0.shape)))
        return real(log_a, gated_x, h0=h0)

    monkeypatch.setattr(ops, "rglru", record)
    x = torch.randn((2, 9, cfg.d_model), generator=torch.Generator().manual_seed(1))
    _, state = t_rglru_model.rglru_block(cfg, p, "blk0.mix", x[:, :8], return_state=True)
    t_rglru_model.rglru_block(cfg, p, "blk0.mix", x[:, 8:], cache=state)
    E = state["h"].shape[-1]
    assert seen == [((2, 8, E), None), ((2, 1, E), (2, E))]


def test_wrapper_rejects_a_wrong_h0():
    la, gx = torch.zeros((2, 5, 8)), torch.zeros((2, 5, 8))
    with pytest.raises(ValueError, match=r"h0 must be \[B,E\]"):
        ops.rglru(la, gx, h0=torch.zeros((2, 1, 8)))
    with pytest.raises(ValueError, match=r"h0 must be \[B,E\]"):
        ops.rglru(la, gx, h0=torch.zeros((3, 8)))
    with pytest.raises(TypeError, match="h0 must be float32"):
        ops.rglru(la, gx, h0=torch.zeros((2, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="h0 on meta"):
        ops.rglru(la, gx, h0=torch.zeros((2, 8), device="meta"))
    with pytest.raises(TypeError, match="b float32 or bfloat16"):
        ops.rglru(la, gx.half())
    with pytest.raises(ValueError, match="share"):
        ops.rglru(la, gx[:, :4])


@pytest.mark.parametrize("with_h0", [True, False])
def test_cuda_tensor_whose_binding_fails_raises(with_h0, monkeypatch):
    """On CUDA tensors the fused entry launches the kernel or raises: a
    binding that cannot load never turns into the plain version's result."""

    def broken(name):
        raise OSError(f"cannot load lib{name}.so")

    monkeypatch.setattr(_build, "load", broken)
    binding.entry.cache_clear()
    launches = (ops.rglru.launches, ops.rglru_scan.launches)
    with FakeTensorMode():  # tensors that say cuda, without a card
        x = torch.empty((2, 16, 32), device="cuda")
        h0 = torch.empty((2, 32), device="cuda") if with_h0 else None
        with pytest.raises(OSError, match="cannot load"):
            ops.rglru(x, x, h0=h0)
    assert (ops.rglru.launches, ops.rglru_scan.launches) == launches
    binding.entry.cache_clear()


@pytest.mark.parametrize("case", chip_smoke.RGLRU_EXACT_CASES[:3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_carry_checks_hold_for_the_plain_version(case, dtype):
    """Phase 10's exact checks (a = 1 counts, a = 0 resets, the fused op
    holds h0 or the last reset's gx) on the plain version, at the cases
    small enough for a CPU loop: they hold the helpers to their algebra."""
    chip_smoke.check_rglru_exact(case, dtype, torch.device("cpu"))
    chip_smoke.check_rglru_repeat(case, dtype, torch.device("cpu"))


def test_exact_cases_reach_the_kernels_edges():
    """S not a multiple of the 64-step chunk and below one chunk, E not a
    multiple of the 128-channel tile, rows that are not 16-byte aligned (the
    per-channel load path), B x E below one tile column, many handoffs."""
    cases = chip_smoke.RGLRU_EXACT_CASES
    assert any(S % 64 for _, S, _ in cases) and any(S < 64 for _, S, _ in cases)
    assert any(E % 128 for _, _, E in cases) and any(E % 4 for _, _, E in cases)
    assert any(B * E <= 128 for B, _, E in cases)
    assert -(-max(S for _, S, _ in cases) // 64) - 1 >= 64  # handoffs down one column


def test_rglru_phase_runs_on_the_cpu():
    """Phase 10's RG-LRU checks at a small serving shape, on the plain
    versions (the plumbing, not the kernel)."""
    assert chip_smoke.rglru_phase((2, 70, 40), torch.device("cpu")) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.RGLRU_EXACT_CASES + [(4, 4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_carry_and_repeat_on_the_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    dev = torch.device("cuda")
    chip_smoke.check_rglru_exact(case, dtype, dev)
    chip_smoke.check_rglru_repeat(case, dtype, dev)


@pytest.mark.cuda
def test_fused_op_matches_plain_composition_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(chip_smoke.RGLRU_CASES):
            for h0 in (False, True):
                chip_smoke.check_rglru_op(case, dtype, dev, seed=i, h0=h0)
