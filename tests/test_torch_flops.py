"""The port's analytic FLOPs / HBM-traffic model (`repro_torch.models.flops`)
against the reference's (`repro.models.flops`), on the CPU.

Parity is exact: the same Python float arithmetic in the same order, so
every number is compared with ``==``. All ten registry configs (and their
reduced forms) x `LM_SHAPES` x the three remat factors, `forward_flops` at
prefill and decode shapes, `cache_bytes`, `cell_hbm_bytes`, and the port's
counterpart of `tests/models/test_int8_cache.py::
test_int8_cache_specs_halve_bytes`.
"""

import dataclasses

import pytest

from repro.configs import registry as r_registry
from repro.models import flops as r_flops
from repro.models.config import LM_SHAPES as R_SHAPES
from repro_torch.configs import registry as t_registry
from repro_torch.models import flops as t_flops
from repro_torch.models.config import LM_SHAPES as T_SHAPES
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = sorted(r_registry.names())
REMATS = ("full", "dots", "none")


def test_registry_shapes_and_remat_factors_are_the_reference():
    assert ARCHS == sorted(t_registry.names()) and len(ARCHS) == 10
    assert [dataclasses.astuple(s) for s in T_SHAPES] == [
        dataclasses.astuple(s) for s in R_SHAPES]
    assert t_flops._REMAT_FACTOR == r_flops._REMAT_FACTOR


@pytest.mark.parametrize("shape", range(len(R_SHAPES)), ids=[s.name for s in R_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_flops_and_bytes_equal_the_reference(arch, shape):
    rc, tc = r_registry.get(arch), t_registry.get(arch)
    rs, ts = R_SHAPES[shape], T_SHAPES[shape]
    for remat in REMATS:
        want = r_flops.cell_flops(rc, rs, remat)
        got = t_flops.cell_flops(tc, ts, remat)
        assert got == want, (remat, got, want)
        assert got["total"] > 0 and got["model"] > 0
    assert t_flops.cell_hbm_bytes(tc, ts) == r_flops.cell_hbm_bytes(rc, rs)
    assert t_flops.cache_bytes(tc, ts.global_batch, ts.seq_len) == r_flops.cache_bytes(
        rc, rs.global_batch, rs.seq_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_and_cache_bytes_equal_the_reference(arch):
    """Odd sizes (S + 1 odd, windows shorter and longer than S, MoE
    capacity products that are not whole), decode against caches of every
    size, and the reduced configs."""
    for get in ("get", "reduced"):
        rc, tc = getattr(r_registry, get)(arch), getattr(t_registry, get)(arch)
        for B, S in ((1, 1), (3, 7), (2, 129), (5, 1000), (1, 4097)):
            assert t_flops.forward_flops(tc, B, S) == r_flops.forward_flops(rc, B, S), (B, S)
            assert t_flops.forward_flops(tc, B, 1, kv_len=S, decode=True) == \
                r_flops.forward_flops(rc, B, 1, kv_len=S, decode=True), (B, S)
            assert t_flops.cache_bytes(tc, B, S) == r_flops.cache_bytes(rc, B, S), (B, S)


def test_int8_cache_specs_halve_bytes():
    cfg = t_registry.get("qwen2-72b")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    b16 = t_flops.cache_bytes(cfg, 128, 32768)
    b8 = t_flops.cache_bytes(cfg8, 128, 32768)
    assert b8 < 0.55 * b16  # ~1.94x reduction (int8 + f32 scales)
    r_cfg8 = dataclasses.replace(r_registry.get("qwen2-72b"), kv_cache_dtype="int8")
    assert b8 == r_flops.cache_bytes(r_cfg8, 128, 32768)
