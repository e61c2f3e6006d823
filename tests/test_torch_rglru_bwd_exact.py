"""The exact reverse-carry cases of the RG-LRU backward, on the CPU.

`chip_smoke.rglru_bwd_exact_case` builds them (phase 21b holds the CUDA
backward to their expected gradients with torch.equal): log_a = 0 (a = 1)
but -inf (a = 0) at scattered (b, t, e), dh = 1, the forward's h of 0s and
1s, so that g_t is the number of steps to the next reset and every expected
gradient is exact in float32. Here those expected values are held, bit for
bit, to the port's plain backward `rglru_bwd_ref` (what `ops.rglru_bwd`
runs on CPU tensors) for every entry, and for the contract entry to
`jax.vjp` of the reference's `repro.kernels.rglru.ref.rglru_ref` (the
Pallas kernel cannot run here: ROADMAP C1). Each case's h is checked to be
the forward's output of its inputs, so the expected gradients are the
gradients of a real forward.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ref import rglru_ref as r_rglru_ref
from repro_torch.kernels.rglru import ops
from repro_torch.kernels.rglru.ref import rglru_bwd_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402 (autouse)

CPU = torch.device("cpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = chip_smoke.RGLRU_EXACT_CASES


def _equal(got, want, label):
    assert (got is None) == (want is None), label
    if want is not None:
        assert got.dtype == want.dtype and torch.equal(got, want), (
            label, (got != want).nonzero()[:3].tolist())


@pytest.mark.parametrize("entry", chip_smoke.RGLRU_BWD_ENTRIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_exact_case_is_the_plain_backward_bit_for_bit(case, dtype, entry):
    args, kw, want = chip_smoke.rglru_bwd_exact_case(case, DTYPES[dtype], CPU, entry)
    log_a, x, h, _ = args
    # h is the forward's output of these inputs (the op's from h0 when fused)
    fwd = ops.rglru(log_a, x, h0=kw["h0"]) if kw else ops.rglru_scan(log_a, x)
    assert torch.equal(fwd, h)
    got = rglru_bwd_ref(*args, **kw)
    for name, g, w in zip(("dlog_a", "dx", "dh0"), got, want):
        _equal(g, w, f"{case} {dtype} {entry} {name}")
    # the wrapper on CPU tensors is the plain backward
    for name, g, w in zip(("dlog_a", "dx", "dh0"), ops.rglru_bwd(*args, **kw), want):
        _equal(g, w, f"ops {case} {dtype} {entry} {name}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_exact_contract_case_is_jax_vjp_of_the_reference(case, dtype):
    (log_a, b, h, dh), _, (want_dla, want_db, _) = chip_smoke.rglru_bwd_exact_case(
        case, DTYPES[dtype], CPU, "contract")
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    la = jnp.asarray(log_a.numpy())
    bj = jnp.asarray(b.float().numpy()).astype(jdt)

    def pull(la, bj, ct):
        out, vjp = jax.vjp(r_rglru_ref, la, bj)
        return (out,) + vjp(ct.astype(out.dtype))

    out, dla, db = jax.jit(pull)(la, bj, jnp.asarray(dh.float().numpy()))
    np.testing.assert_array_equal(np.asarray(out, np.float32), h.float().numpy())
    np.testing.assert_array_equal(np.asarray(dla, np.float32), want_dla.numpy())
    assert db.dtype == jdt
    np.testing.assert_array_equal(np.asarray(db, np.float32), want_db.float().numpy())


def test_exact_cases_reach_the_kernels_edges():
    """S below one 32-step chunk, S not a multiple of it, E not a multiple of
    the 128-channel tile, rows not 16-byte aligned, dozens of handoffs a
    column; and resets at scattered (b, t, e), chunk boundaries among them."""
    kTC, kTE = 32, 128
    S_all = [c[1] for c in CASES]
    E_all = [c[2] for c in CASES]
    assert min(S_all) < kTC and any(S % kTC for S in S_all if S > kTC)
    assert any(E % kTE for E in E_all) and any(E % 4 for E in E_all)
    assert -(-max(S_all) // kTC) - 1 >= 64  # handoffs down one column
    log_a, _ = chip_smoke.rglru_resets(CASES[3], CPU)
    t = torch.isneginf(log_a).nonzero()[:, 1]
    assert bool(((t % kTC) == kTC - 1).any()) and bool(((t % kTC) == 0).any())
